"""Pass 6 — the device-memory certifier and static footprint planner.

The port of ``lighthouse_tpu/analysis/memory.py``, against the H100's own
memory: its HBM and its per-block shared-memory opt-in (the reference's
tiers are TPU chips, HBM and 16 MiB VMEM).

* **Graph footprints** — every graph of ``bounds.graph_registry`` runs on
  the ``meta`` device under a ``TorchDispatchMode`` liveness walk: every
  storage an op creates is charged (as the CUDA caching allocator charges
  it, rounded up to 512 bytes) until its last tensor dies, views cost
  nothing; argument, output, temp and peak bytes per graph and batch.
  Storages are tracked by ``StorageWeakRef`` (on meta every ``data_ptr()``
  is 0). It replaces the reference's jaxpr walk; the card cross-checks it
  (``chip_smoke.py`` phase 24: the walk's peak is no lower than
  ``max_memory_allocated`` for the same graph on the card).
* **Shared-memory walk** — every plan schedule's and chain program's
  ``smem_bytes`` at each cluster the launcher can choose (1, 2, 4, 8; 1
  for a schedule without an output map), against the tier's per-block
  opt-in. It replaces the reference's VMEM tile walk.
* **Subsystem residency models** — one static ``*_bytes(config)`` function
  per device-resident structure (epoch mirror, slasher span planes, LC
  committee cache, KZG tables, firehose staging), equal to the ``nbytes``
  of the real structures (``tests/test_torch_analysis_memory.py``, and on
  the card beside the allocator's change, ``chip_smoke.py`` phase 24).
* **Device tiers** — ``h100_80gb`` (the card's HBM as torch reports it, its
  shared-memory opt-in per block; beside them the card's name and power
  limit) and an unbounded ``cpu_proxy``. A row that fits no declared finite
  tier fails the certificate exactly like a tripped bound.
* **Planner** — ``max_safe_shape(graph, tier)`` is the largest certified
  pow2 batch per tier; ``rung_fit`` prices a bench rung (its mode names are
  the reference's).

Every knob is an argument (the tier, the slasher history); the module reads
no environment variable. ``python -m lighthouse_tpu_torch.analysis`` writes
the certificate to ``lighthouse_tpu_torch/_build/analysis/MEMORY_CERT.json``,
which ``fault_memory_context`` reads.
"""

from __future__ import annotations

import functools
import os
import weakref

__all__ = [
    "DEVICE_TIERS",
    "DEFAULT_TIER",
    "certify_memory",
    "certify_graph_callable",
    "epoch_mirror_bytes",
    "slasher_span_bytes",
    "lc_committee_cache_bytes",
    "kzg_table_bytes",
    "firehose_staging_bytes",
    "graph_footprint",
    "smem_walk",
    "max_safe_shape",
    "rung_fit",
    "fault_memory_context",
    "write_cert",
]

# Declared device tiers. h100_80gb: the card this port runs on, as
# torch.cuda.get_device_properties reports it (total_memory,
# shared_memory_per_block_optin) on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi --query-gpu=name,power.limit); chip_smoke.py phase 24 checks
# both numbers against the card. The CPU proxy is unbounded: host runs
# certify shapes, never fail them.
DEVICE_TIERS: dict[str, dict] = {
    "h100_80gb": {
        "hbm_bytes": 85_017_493_504,
        "smem_block_optin_bytes": 232_448,
        "card": "NVIDIA H100 80GB HBM3",
        "power_limit": "700.00 W",
    },
    "cpu_proxy": {"hbm_bytes": None, "smem_block_optin_bytes": None},
}
DEFAULT_TIER = "h100_80gb"

_DEFAULT_BATCHES = (1, 32)
# the CUDA caching allocator's block granularity: every allocation is
# charged a multiple of it
ALLOC_ROUND = 512
# ... and above this size (its large pool) it hands out a cached block
# unsplit when no more than this much would remain: such an allocation can
# be charged up to this much more than it asked for
ALLOC_LARGE = 1 << 20


def alloc_bytes(nbytes: int) -> int:
    """Bytes the card's caching allocator charges for an allocation."""
    return -(-int(nbytes) // ALLOC_ROUND) * ALLOC_ROUND if nbytes else 0


def _pow2_bucket(n: int, floor: int) -> int:
    """Twin of the pow2 shape buckets used at every allocation site
    (``epoch_engine.kernels.bucket``, ``slasher.engine._bucket``,
    ``firehose.sharding._bucket``), pinned equal by the tests."""
    b = max(1, int(floor))
    n = max(1, int(n))
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------------------
# Subsystem residency models (static; held against the real structures'
# nbytes by the tests and against the card's allocator by chip_smoke.py)
# --------------------------------------------------------------------------------------

# epoch_engine/mirror.py _REG_DTYPES: five u64 columns (int64 on the device:
# effective, activation, exit, withdrawable, eligibility) + two bool columns
# (slashed, compounding), each at the 256-floor pow2 validator bucket.
_MIRROR_COLUMN_BYTES = 5 * 8 + 2 * 1
# the per-epoch uploads co-resident during a sweep: balances and inactivity
# (int64), previous/current participation (uint8)
_EPOCH_PLANE_BYTES = 8 + 8 + 1 + 1


def epoch_mirror_bytes(validators: int, include_epoch_planes: bool = True,
                       mesh_devices: int = 1) -> int:
    """Device-resident bytes of the registry mirror at ``validators``, on
    each device of a mesh of ``mesh_devices`` (the row blocks: the padded
    bucket split evenly; 1 = one device holding every row).
    ``include_epoch_planes`` adds the per-epoch planes a sweep uploads;
    without them the figure equals ``MirrorStats.host_to_device_bytes``
    after one full gather."""
    n_pad = _pow2_bucket(validators, 256)
    per_row = _MIRROR_COLUMN_BYTES + (_EPOCH_PLANE_BYTES if include_epoch_planes else 0)
    return n_pad // int(mesh_devices) * per_row


def slasher_span_bytes(validators: int, history: int = 4096, floor: int = 256) -> int:
    """Device-resident bytes of the slasher span planes: biased int16
    min-distance + int16 max-distance + int32 vote tags at [n_pad, history]
    (``slasher/kernels.py empty_planes``: the reference's u16/u16/u32
    widths); ``history`` 4096 is Lighthouse's default window."""
    n_pad = _pow2_bucket(validators, floor)
    return n_pad * int(history) * (2 + 2 + 4)


def lc_committee_cache_bytes(periods: int, committee_size: int = 512) -> int:
    """Device-resident bytes of the LC per-period committee cache:
    [P_pad, C, 3, 25] int64 (``light_client/engine.py cache_arr``; P_pad the
    4-floor pow2 bucket, C the SYNC_COMMITTEE_SIZE)."""
    p_pad = _pow2_bucket(periods, 4)
    return p_pad * int(committee_size) * 3 * 25 * 8


def kzg_table_bytes(cells: int = 128, k: int = 64) -> int:
    """Device-resident bytes of the KZG CellEngine's verify tables
    (``kzg/engine.py tables``/``z2_tab``), storage by storage: perm
    int64[k], idft [k, k, 25], cinv [cells, k, 25], dtab [cells, 25], setup
    [k, 3, 25], the G2 generator and [tau^k]G2 as two projective [6, 25]
    points (g2x/g2y and t2x/t2y are their x and y rows), and the coset-shift
    table z2 [cells, 6, 25]; all int64. The reference's layout differs in
    two places: perm is int32 there, and it keeps the four affine rows
    [2, 25] as arrays of their own (no z rows)."""
    cells, k = int(cells), int(k)
    return (
        8 * k                    # perm
        + 8 * 25 * k * k         # idft
        + 8 * 25 * cells * k     # cinv
        + 8 * 25 * cells         # dtab
        + 8 * 25 * 3 * k         # setup (g1 projective rows)
        + 2 * 8 * 25 * 6         # the G2 generator and [tau^k]G2, projective
        + 8 * 25 * 6 * cells     # z2 (g2 projective rows)
    )


# bls/backend.py prepare_batch (one device) and bls/sharded.py put_staged
# (each shard) per-row device bytes, k_pad key columns: u0/u1 [2, 25] and
# sxc0/sxc1 [25] int64, s_flag int64, sig_wf bool, scalars int64 (the
# uint64 bit patterns), valid bool; per key column idx int64 + mask bool.
# The reference's idx is int32: 5 bytes per key column there, 9 here.
_STAGED_ROW_FIXED_BYTES = 2 * (2 * 25 * 8) + 2 * (25 * 8) + 8 + 1 + 8 + 1
_STAGED_KEY_BYTES = 8 + 1


def staged_tick_bytes(n_pad: int, k_pad: int) -> int:
    """One staged tick at explicit row/key padding."""
    return int(n_pad) * (_STAGED_ROW_FIXED_BYTES + _STAGED_KEY_BYTES * int(k_pad))


def firehose_staging_bytes(max_batch: int = 64, prep_depth: int = 1, k_pad: int = 4,
                           n_shards: int = 1) -> int:
    """Device-resident bytes of the firehose's staged batches: one tick's
    per-shard inputs (each shard padded to the pow2 batch bucket),
    ``prep_depth + 1`` deep (the prep thread stages tick N+1 while the
    device thread verifies tick N)."""
    n_pad = int(n_shards) * _pow2_bucket(max_batch, 4)
    return (int(prep_depth) + 1) * staged_tick_bytes(n_pad, k_pad)


def _residency_ladder(slasher_history: int) -> list[tuple[str, int]]:
    rows = []
    for v in (32_768, 262_144, 1_048_576):
        rows.append((f"residency/epoch_mirror@{v}", epoch_mirror_bytes(v)))
        rows.append((f"residency/slasher_spans@{v}", slasher_span_bytes(v, slasher_history)))
    rows.append(("residency/epoch_mirror@1048576x4blocks", epoch_mirror_bytes(1 << 20, True, 4)))
    for p in (4, 64):
        rows.append((f"residency/lc_committee_cache@{p}p", lc_committee_cache_bytes(p)))
    rows.append(("residency/kzg_tables@mainnet", kzg_table_bytes()))
    rows.append(("residency/firehose_staging@64x1", firehose_staging_bytes()))
    rows.append(("residency/firehose_staging@64x4shards", firehose_staging_bytes(n_shards=4)))
    return rows


# --------------------------------------------------------------------------------------
# Tier arithmetic
# --------------------------------------------------------------------------------------


def _tier_fit(nbytes: int, tiers: dict) -> tuple[str | None, dict]:
    """(smallest finite tier that fits | None, per-tier margin map). The CPU
    proxy (cap None) never bounds a row and never satisfies the fit."""
    margins: dict[str, int | None] = {}
    best: tuple[int, str] | None = None
    for name, caps in tiers.items():
        cap = caps.get("hbm_bytes")
        if cap is None:
            margins[name] = None
            continue
        margins[name] = int(cap) - int(nbytes)
        if cap >= nbytes and (best is None or cap < best[0]):
            best = (cap, name)
    return (best[1] if best else None), margins


def _smem_fit(nbytes: int, tiers: dict) -> bool:
    caps = [c.get("smem_block_optin_bytes") for c in tiers.values()
            if c.get("smem_block_optin_bytes") is not None]
    return bool(caps) and int(nbytes) <= max(caps)


# --------------------------------------------------------------------------------------
# Graph footprints: a TorchDispatchMode liveness walk over the meta execution
# --------------------------------------------------------------------------------------


@functools.cache
def _live_bytes_mode():
    """A dispatch mode charging every storage an op creates until its last
    tracked tensor dies (views add no bytes)."""
    import torch
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._pytree import tree_flatten

    from .bounds import _abstract_mode_cls

    class LiveBytes(_abstract_mode_cls()):
        def __init__(self, known=()):
            super().__init__()
            self.live: dict = {}    # StorageWeakRef -> [charged, tracked tensors, slack]
            self.known = set(known)  # storages live before the walk (arguments)
            self.pending: list = []  # storages whose tracked tensors all died
            self.held: list = []     # ... whose storage something else still holds
            self.n = 0
            self.cur = 0
            self.slack = 0   # what the live large allocations can be charged beyond
            self.peak = 0
            self.peak_alloc = 0
            self.temps = 0

        def _release(self, ref) -> None:
            rec = self.live.get(ref)
            if rec is None:
                return
            rec[1] -= 1
            if rec[1] <= 0:
                self.pending.append(ref)

        def _free_expired(self, refs: list) -> list:
            keep = []
            for ref in refs:
                rec = self.live.get(ref)
                if rec is None:
                    continue
                if ref.expired():
                    self.cur -= rec[0]
                    self.slack -= rec[2]
                    del self.live[ref]
                elif rec[1] <= 0:
                    keep.append(ref)
            return keep

        def _sweep(self) -> None:
            # a storage held past its tensors (a view's base inside an op)
            # is rechecked every 256 ops, not every op
            if self.pending:
                self.held += self._free_expired(self.pending)
                self.pending = []
            self.n += 1
            if self.held and not self.n % 256:
                self.held = self._free_expired(self.held)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = self.run(func, args, kwargs)
            self._sweep()
            for t in tree_flatten(out)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                ref = StorageWeakRef(st)
                if ref in self.known:
                    continue
                rec = self.live.get(ref)
                if rec is None:
                    nb = alloc_bytes(st.nbytes())
                    rec = self.live[ref] = [nb, 0, ALLOC_LARGE if nb > ALLOC_LARGE else 0]
                    self.cur += nb
                    self.slack += rec[2]
                    self.temps += nb
                rec[1] += 1
                weakref.finalize(t, self._release, ref)
            self.peak = max(self.peak, self.cur)
            self.peak_alloc = max(self.peak_alloc, self.cur + self.slack)
            return out

    return LiveBytes


def _tensors(x) -> list:
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(ts) -> int:
    from torch.multiprocessing.reductions import StorageWeakRef

    seen, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref not in seen:
            seen.add(ref)
            total += alloc_bytes(st.nbytes())
    return total


def graph_footprint(fn, specs, device="meta") -> dict:
    """(arg, out, temp, peak) bytes of one graph run on ``device`` (``meta``
    by default: no data, no arithmetic), each storage charged as the card's
    caching allocator charges a block it splits to size; and
    ``peak_alloc_bytes``, the peak with every live allocation above
    ALLOC_LARGE charged ALLOC_LARGE more (a cached block handed out
    unsplit): what the allocator's count can reach. Raises what the graph
    raises."""
    from torch.multiprocessing.reductions import StorageWeakRef

    from .bounds import materialize

    args = materialize(specs, device)
    arg_ts = _tensors(args)
    arg_b = _storage_bytes(arg_ts)
    mode_cls = _live_bytes_mode()
    mode = mode_cls(StorageWeakRef(t.untyped_storage()) for t in arg_ts)
    with mode:
        out = fn(*args)
    out_b = _storage_bytes(_tensors(out))
    peak = max(arg_b + mode.peak, arg_b + out_b)
    return {
        "arg_bytes": arg_b,
        "out_bytes": out_b,
        "temp_bytes": mode.temps,
        "peak_bytes": peak,
        "peak_alloc_bytes": max(peak, arg_b + mode.peak_alloc),
    }


def _footprint_row(name: str, fn, specs, tiers: dict, sink=None) -> dict:
    """The footprint row of one graph run; with a bounds ``sink`` installed
    the run also records the graph's obligations (one run, both passes)."""
    try:
        if sink is None:
            fp = graph_footprint(fn, specs)
        else:
            with sink.context(name):
                fp = graph_footprint(fn, specs)
    except Exception as e:  # noqa: BLE001 — a broken graph is a finding
        if sink is not None:
            with sink.context(name):
                kind = "unproven_bound" if isinstance(e, AssertionError) else "trace_error"
                sink.fail(kind, str(e) if kind == "unproven_bound" else f"{type(e).__name__}: {e}")
        return {"graph": name, "kind": "trace_error",
                "error": f"{type(e).__name__}: {e}"[:300], "ok": False}
    fit_tier, margins = _tier_fit(fp["peak_alloc_bytes"], tiers)
    return {
        "graph": name,
        "kind": "graph_footprint",
        **fp,
        "min_tier": fit_tier,
        "margin_bytes": {k: v for k, v in margins.items() if v is not None},
        "ok": fit_tier is not None,
    }


def certify_graph_callable(fn, specs, tiers: dict | None = None) -> list[dict]:
    """Footprint-certify ONE callable (fixture corpus / mutation tests — the
    memory twin of ``bounds.certify_callable``)."""
    return [_footprint_row(getattr(fn, "__name__", "callable"), fn, specs,
                           tiers or DEVICE_TIERS)]


# --------------------------------------------------------------------------------------
# Shared-memory walk
# --------------------------------------------------------------------------------------

CLUSTERS = (1, 2, 4, 8)


def smem_walk(tiers: dict | None = None) -> list[dict]:
    """One row per (plan schedule or chain program, cluster the launcher
    can choose) this process has derived: its dynamic shared memory
    against the tiers' per-block opt-in."""
    from ..ops.bls import fused_mul

    tiers = tiers or DEVICE_TIERS
    with fused_mul._LOCK:
        scheds = dict(fused_mul.SCHEDULES)
        chains = dict(fused_mul.CHAINS)
    rows = []
    for label, s in sorted(scheds.items()):
        for C in CLUSTERS if s.has_out else (1,):
            smem = s.smem_bytes(C)
            rows.append({"graph": f"smem/plan/{label}", "kind": "smem_tile", "kernel": "plan",
                         "schedule": label, "cluster": C, "lanes": s.L, "threads": s.threads(C),
                         "smem_bytes": smem, "ok": _smem_fit(smem, tiers)})
    for name, prog in sorted(chains.items()):
        clustered = all(s.has_out for s in prog.scheds)
        for C in CLUSTERS if clustered else (1,):
            threads, _lw, _aw, smem = prog.launch_shape(C)
            rows.append({"graph": f"smem/chain/{name}", "kind": "smem_tile", "kernel": "chain",
                         "schedule": name, "cluster": C, "threads": threads,
                         "smem_bytes": smem, "ok": _smem_fit(smem, tiers)})
    return rows


def launch_in_walk(rows: list[dict], kind: str, label: str, n_rows: int) -> bool:
    """Whether a launch the path made ((kind, label, rows), as
    ``fused_mul.launch_log`` keys it) is covered by the shared-memory
    walk: its schedule at the cluster those rows pick."""
    from ..ops.bls import fused_mul

    if kind == "CHAIN":
        C = fused_mul.CHAINS[label].cluster(n_rows)
        kernel = "chain"
    else:
        s = fused_mul.SCHEDULES[label]
        C = fused_mul.cluster_size(n_rows, s.L) if s.has_out else 1
        kernel = "plan"
    return any(r["kernel"] == kernel and r["schedule"] == label and r["cluster"] == C
               for r in rows)


# --------------------------------------------------------------------------------------
# The certificate
# --------------------------------------------------------------------------------------


def certify_memory(batches=_DEFAULT_BATCHES, graphs=None, tiers: dict | None = None,
                   slasher_history: int = 4096,
                   sink=None) -> dict:
    """Run the memory certificate: every registry graph x batch regime on
    the meta device, the shared-memory walk, the five residency models and
    the per-tier planner. ``graphs`` optionally restricts to names
    containing any of the given substrings (the residency rows always run:
    they are arithmetic). With a ``bounds.CertSink`` as ``sink`` the same
    runs also record the bounds certificate's obligations (the CLI then
    runs the registry once for both passes: ``bounds.cert_from_sink``)."""
    import contextlib

    from .bounds import REGIME, _import_certs, _sink_installed, graph_registry

    tiers = tiers or DEVICE_TIERS
    rows: list[dict] = []
    graph_registry(1)  # imports the graphs' modules: their import-time proofs stay out
    with _sink_installed(sink) if sink is not None else contextlib.nullcontext():
        if sink is not None:
            _import_certs(sink)
        for batch in batches:
            regime = f"{REGIME}@b{batch}"
            for name, fn, specs in graph_registry(batch):
                if graphs and not any(s in name for s in graphs):
                    continue
                rows.append(_footprint_row(f"{regime}/{name}", fn, specs, tiers, sink))
    rows.extend(smem_walk(tiers))
    for name, nbytes in _residency_ladder(slasher_history):
        fit_tier, margins = _tier_fit(nbytes, tiers)
        rows.append({
            "graph": name, "kind": "residency", "resident_bytes": int(nbytes),
            "min_tier": fit_tier,
            "margin_bytes": {k: v for k, v in margins.items() if v is not None},
            "ok": fit_tier is not None,
        })
    failed = [r for r in rows if not r["ok"]]
    peaks = _peak_table(rows)
    planner = {
        tier: {g: max_safe_shape_from_peaks(p, tiers[tier]) for g, p in peaks.items()}
        for tier in tiers
    }
    return {
        "version": 1,
        "tool": "python -m lighthouse_tpu_torch.analysis --memory",
        "regime": REGIME,
        "batches": list(batches),
        "tiers": {k: dict(v) for k, v in tiers.items()},
        "default_tier": DEFAULT_TIER,
        "slasher_history": slasher_history,
        "ok": not failed,
        "n_rows": len(rows),
        "n_failed": len(failed),
        "peaks": peaks,
        "planner": planner,
        "rows": rows,
    }


def _peak_table(rows: list[dict]) -> dict:
    """{base graph name: {batch: the peak bytes the allocator can reach}} —
    the compact table the planner and the rung gate consume."""
    peaks: dict[str, dict] = {}
    for r in rows:
        if r.get("kind") != "graph_footprint":
            continue
        regime, _, base = r["graph"].partition("/")
        _, _, b = regime.partition("@b")
        try:
            batch = int(b)
        except ValueError:
            continue
        d = peaks.setdefault(base, {})
        d[str(batch)] = max(d.get(str(batch), 0), r["peak_alloc_bytes"])
    return peaks


def max_safe_shape_from_peaks(batch_peaks: dict, tier_caps: dict,
                              max_batch: int = 1 << 20) -> int | None:
    """Largest pow2 batch whose extrapolated peak fits ``tier_caps``. The
    peak model is affine in batch, fit through the certified regimes. None =
    no certified data; an unbounded tier certifies the probe ceiling."""
    cap = tier_caps.get("hbm_bytes")
    pts = sorted((int(b), int(p)) for b, p in batch_peaks.items())
    if not pts:
        return None
    if cap is None:
        return max_batch
    if len(pts) == 1:
        b0, p0 = pts[0]
        slope = p0 / max(1, b0)
        base = 0.0
    else:
        (b0, p0), (b1, p1) = pts[0], pts[-1]
        slope = (p1 - p0) / max(1, b1 - b0)
        base = p0 - slope * b0
    if base > cap:
        return None
    best = None
    b = 1
    while b <= max_batch:
        if base + slope * b <= cap:
            best = b
        b *= 2
    return best


def max_safe_shape(graph: str, tier: str, cert: dict | None = None) -> int | None:
    """Largest certified pow2 batch of ``graph`` on ``tier``, from the
    planner of ``cert`` (or of the certificate under ``_build/analysis/``)."""
    cert = cert or load_cert()
    if cert is None:
        return None
    planner = cert.get("planner", {}).get(tier)
    if planner is None:
        caps = cert.get("tiers", DEVICE_TIERS).get(tier)
        if caps is None:
            return None
        peaks = cert.get("peaks", {}).get(graph)
        return max_safe_shape_from_peaks(peaks, caps) if peaks else None
    return planner.get(graph)


def cert_dir() -> str:
    """Where the CLI writes its certificates: the package's build directory
    (ignored by git), never the repository root."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "_build", "analysis")


def load_cert(path: str | None = None) -> dict | None:
    import json

    path = path or os.path.join(cert_dir(), "MEMORY_CERT.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_cert(cert: dict, path: str) -> None:
    import json

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cert, f, indent=1)
        f.write("\n")


# --------------------------------------------------------------------------------------
# Rung gating + fault enrichment
# --------------------------------------------------------------------------------------

# Representative certified graph per bench rung mode (the reference's mode
# names): the rung's device working set is the graph peak extrapolated to
# the rung batch, plus the mode's resident planes.
_MODE_GRAPH = {
    "sets": "pairing.miller_loop_product",
    "firehose": "pairing.miller_loop_product",
    "overload": "pairing.miller_loop_product",
    "firehose_sharded": "tpu_backend.shard_local_pair_verdict",
    "h2c": "h2c.map_to_g2",
    "pairing": "pairing.miller_loop",
    "kzg_cells": "kzg.fr_dot",
    "light_clients": "lc.batch_check",
    "epoch": "epoch.sweep_electra",
    "epoch_sharded": "epoch.sweep_electra",
    "slasher": "slasher.sweep",
}

_VALIDATOR_MODES = ("epoch", "epoch_sharded", "slasher")


def _graph_peak_at(cert: dict | None, graph: str, batch: int) -> int | None:
    if cert is None:
        return None
    peaks = cert.get("peaks", {}).get(graph)
    if not peaks:
        return None
    pts = sorted((int(b), int(p)) for b, p in peaks.items())
    if len(pts) == 1:
        b0, p0 = pts[0]
        return int(p0 / max(1, b0) * max(1, batch))
    (b0, p0), (b1, p1) = pts[0], pts[-1]
    slope = (p1 - p0) / max(1, b1 - b0)
    return int(max(p0, p0 + slope * (batch - b0)))


# the sharded firehose rung's shards: the serving mesh chip_smoke.py runs
_RUNG_SHARDS = 4


def rung_fit(mode: str, sets: int, keys: int, validators: int, batch: int,
             tier: str = DEFAULT_TIER, cert: dict | None = None,
             tier_caps: dict | None = None, slasher_history: int = 64) -> dict:
    """Static fit verdict for one bench ladder rung on ``tier``: {fits,
    domain, predicted_bytes, cap_bytes, margin_bytes, tier}. Pure arithmetic
    over the residency models plus the certificate's peak table when one is
    given; a missing certificate predicts only the residency component.
    ``slasher_history`` is the window the slasher rung configures (the
    reference bench's 64)."""
    caps = tier_caps or (cert or {}).get("tiers", {}).get(tier) or DEVICE_TIERS.get(tier, {})
    cap = caps.get("hbm_bytes")
    resident = 0
    if mode in ("epoch", "epoch_sharded"):
        resident += epoch_mirror_bytes(max(validators, 1))
    elif mode == "slasher":
        resident += slasher_span_bytes(max(validators, 1), history=slasher_history)
    elif mode == "kzg_cells":
        resident += kzg_table_bytes()
    elif mode == "light_clients":
        resident += lc_committee_cache_bytes(4)
    elif mode in ("firehose", "overload", "firehose_sharded"):
        shards = _RUNG_SHARDS if mode == "firehose_sharded" else 1
        resident += firehose_staging_bytes(max_batch=max(batch, 1), n_shards=shards)
    graph = _MODE_GRAPH.get(mode)
    peak = None
    if graph is not None:
        if mode in _VALIDATOR_MODES:
            p256 = _graph_peak_at(cert, graph, 1)
            if p256 is not None:
                peak = int(p256 * _pow2_bucket(max(validators, 1), 256) / 256)
        else:
            peak = _graph_peak_at(cert, graph, max(batch, 1))
    predicted = resident + (peak or 0)
    fits = cap is None or predicted <= cap
    return {
        "fits": bool(fits), "tier": tier, "domain": mode, "graph": graph,
        "predicted_bytes": int(predicted), "resident_bytes": int(resident),
        "graph_peak_bytes": peak, "cap_bytes": cap,
        "margin_bytes": None if cap is None else int(cap) - int(predicted),
    }


# fault domain -> (residency gauge, certified graph) for OOM enrichment: an
# ``oom``-classified fault record carries what the static model predicted
# for its domain.
_DOMAIN_INFO = {
    "epoch_device": ("EPOCH_MIRROR_BYTES", "epoch.sweep_electra"),
    "slasher_device": ("SLASHER_SPAN_PLANE_BYTES", "slasher.sweep"),
    "lc_device": ("LC_COMMITTEE_CACHE_BYTES", "lc.batch_check"),
    "kzg_device": ("KZG_TABLE_BYTES", "kzg.fr_dot"),
    "firehose": (None, "pairing.miller_loop_product"),
    "bls_device": (None, "pairing.miller_loop_product"),
}


def fault_memory_context(domain: str, tier: str | None = None) -> dict | None:
    """Static-memory context attached to an ``oom``-classified fault record:
    the domain's certified peak bytes (from ``_build/analysis/
    MEMORY_CERT.json`` when present), its live device-resident bytes (from
    the residency gauges), and the margin against ``tier`` (default
    ``h100_80gb``). Best-effort: None for unknown domains, never raises."""
    try:
        info = _DOMAIN_INFO.get(domain)
        if info is None:
            return None
        gauge_name, graph = info
        tier = tier or DEFAULT_TIER
        cap = DEVICE_TIERS.get(tier, {}).get("hbm_bytes")
        resident = None
        if gauge_name is not None:
            from ..utils import metrics

            g = getattr(metrics, gauge_name, None)
            if g is not None:
                vals = [v for _, _, v in g.collect()]
                resident = int(max(vals)) if vals else None
        cert = load_cert()
        peak = _graph_peak_at(cert, graph, 32) if cert else None
        out = {
            "tier": tier,
            "tier_hbm_bytes": cap,
            "certified_peak_bytes": peak,
            "resident_bytes": resident,
        }
        if cap is not None:
            out["margin_bytes"] = int(cap) - int((resident or 0) + (peak or 0))
        return out
    except Exception:  # noqa: BLE001 — enrichment must never fail a record
        return None


def tensor_bytes(tensors) -> int:
    """Sum of the distinct storages' bytes of ``tensors`` (views counted
    once): a structure's nbytes, as its models count it."""
    from torch.multiprocessing.reductions import StorageWeakRef

    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref not in seen:
            seen.add(ref)
            total += st.nbytes()
    return total


def rounded_bytes(tensors) -> int:
    """The same storages as the card's allocator charges them."""
    return _storage_bytes(list(tensors))

