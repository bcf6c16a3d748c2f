"""The port's slasher against the reference's.

``lighthouse_tpu_torch.slasher`` is the port of ``lighthouse_tpu.slasher``:
the span sweep as PyTorch (``kernels.sweep_``, biased int16/int32 planes at
the reference's widths, tiled over rows), the seed per-row path
(``arrays``, ``db``, ``slasher``), the engine (``engine``) and the service.
The same inputs, made from a seed with numpy, go through both packages and
must agree exactly: all three planes (mapped back to uint16/uint32) and all
five per-pair outputs of the sweep, the row update's tiles and reads, the
slashings emitted on the reference tests' streams, the seed path's KV rows
and the engine's checkpoint bytes. The port runs on ``device="cpu"`` (the
same torch code a card runs); the reference's sweep and row update run
under ``jax.jit`` on the CPU.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu.resilience import injector as r_injector
from lighthouse_tpu.slasher import Slasher as RSlasher
from lighthouse_tpu.slasher import SlasherConfig as RConfig
from lighthouse_tpu.slasher import SlasherService as RService
from lighthouse_tpu.slasher import make_slasher as r_make
from lighthouse_tpu.slasher.engine import empty_planes_np, sweep_numpy
from lighthouse_tpu.store.kv import DBColumn as RCol
from lighthouse_tpu.store.kv import MemoryStore as RStore
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.resilience import injector, reset_all, slasher_supervisor
from lighthouse_tpu_torch.slasher import Slasher as PSlasher
from lighthouse_tpu_torch.slasher import SlasherConfig as PConfig
from lighthouse_tpu_torch.slasher import SlasherService as PService
from lighthouse_tpu_torch.slasher import kernels as pk
from lighthouse_tpu_torch.slasher import make_slasher as p_make
from lighthouse_tpu_torch.slasher.engine import EngineSlasher, SpanStore
from lighthouse_tpu_torch.store.kv import DBColumn as PCol
from lighthouse_tpu_torch.store.kv import MemoryStore as PStore
from lighthouse_tpu_torch.types import containers as p_con

R_NS, P_NS = r_con.for_preset("minimal"), p_con.for_preset("minimal")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_backend():
    """The port's slasher on the CPU; inert injectors, fresh supervisors."""
    saved = (p_slasher.get_backend(), p_slasher.get_device())
    p_slasher.set_backend("device", device="cpu")
    injector.clear()
    r_injector.clear()
    reset_all()
    yield
    injector.clear()
    r_injector.clear()
    reset_all()
    p_slasher.set_backend(saved[0], device=saved[1])


def _att(pkg, indices, source, target, seed=0):
    con, ns = (r_con, R_NS) if pkg == "r" else (p_con, P_NS)
    return ns.IndexedAttestation(
        attesting_indices=[int(i) for i in indices],
        data=con.AttestationData(
            slot=int(target) * 8,
            index=0,
            beacon_block_root=bytes([seed % 256]) * 32,
            source=con.Checkpoint(epoch=int(source), root=b"\x01" * 32),
            target=con.Checkpoint(epoch=int(target), root=b"\x02" * 32),
        ),
        signature=b"\x00" * 96,
    )


def _header(pkg, slot, proposer, body_byte=0):
    con = r_con if pkg == "r" else p_con
    return con.SignedBeaconBlockHeader(
        message=con.BeaconBlockHeader(
            slot=slot, proposer_index=proposer, parent_root=b"\x00" * 32,
            state_root=b"\x00" * 32, body_root=bytes([body_byte]) * 32,
        ),
        signature=b"\x00" * 96,
    )


def _keys(slashings):
    return sorted(type(s).hash_tree_root(s) for s in slashings)


def _rand_pairs(rng, v_cap, cur, n, p):
    """Pairs with out-of-range rows, out-of-window and reversed (source >
    target) votes, repeated tags on shared cells (intra-batch conflicts),
    the all-ones tag and an invalid (padding) fifth."""
    vidx = rng.integers(0, v_cap + 3, p).astype(np.int64)
    tgt = rng.integers(cur - n - 3, cur + 3, p).astype(np.int64)
    src = tgt - rng.integers(-1, 6, p)
    vh = rng.integers(1, 6, p).astype(np.uint32)
    vh[rng.random(p) < 0.05] = 0xFFFFFFFF
    valid = rng.random(p) > 0.2
    return vidx, src, tgt, vh, valid


# =============================================================================
# the span sweep: the reference's jit and numpy twin, bit for bit
# =============================================================================


@pytest.mark.parametrize("n", [64, 128])
def test_sweep_equals_reference_and_twin(n):
    """Randomized streams at V = 512: window advances (one past the whole
    window), out-of-window and invalid pairs, intra-batch tag conflicts and
    padding. Every plane and per-pair output equals the reference's
    ``kernels.sweep`` and ``sweep_numpy``, the port's planes staying on its
    device between batches."""
    import jax.numpy as jnp

    from lighthouse_tpu.slasher import kernels as rk

    rng = np.random.default_rng(n)
    v = 512
    planes = list(empty_planes_np(v, n))
    dev_planes = pk.planes_to_device(*planes, "cpu")
    epoch, cur = 35, 40
    deltas = []
    for step in range(8):
        delta = cur - epoch
        deltas.append(delta)
        args = _rand_pairs(rng, v, cur, n, 256)
        twin = sweep_numpy(*planes, delta, *args, cur, n)
        ref = rk.sweep(
            *(jnp.asarray(a) for a in planes), jnp.int32(delta),
            *(jnp.asarray(a, jnp.int32) for a in args[:3]), jnp.asarray(args[3]),
            jnp.asarray(args[4]), jnp.int32(cur), n=n,
        )
        pair = pk.sweep_(dev_planes, delta, *args, cur, n=n)
        got = (*pk.planes_from_device(dev_planes), *(x.numpy() for x in pair))
        for i, (a, b, c) in enumerate(zip(twin, ref, got)):
            b = np.asarray(b)
            assert c.dtype == b.dtype, (i, c.dtype, b.dtype)
            np.testing.assert_array_equal(c, b, err_msg=f"field {i}, step {step}")
            np.testing.assert_array_equal(c, a, err_msg=f"field {i}, step {step}")
        planes = list(twin[:3])
        epoch = cur
        cur += int(rng.integers(0, 3)) if step != 4 else n + 7
    assert any(d > n for d in deltas) and any(0 < d <= 2 for d in deltas)


@pytest.mark.parametrize("rows", [1, 37])
def test_tiled_sweep_equals_untiled(rows):
    """Tiles that split the registry unevenly (37 of 300 rows, and one row a
    tile) give the untiled sweep's planes and outputs, advances included."""
    rng = np.random.default_rng(5)
    v, n = 300, 64
    whole = pk.empty_planes(v, n, "cpu")
    tiled = pk.empty_planes(v, n, "cpu")
    cur = 70
    for step in range(4):
        args = _rand_pairs(rng, v, cur, n, 200)
        a = pk.sweep_(whole, 1 if step else 0, *args, cur, n=n, rows=v)
        b = pk.sweep_(tiled, 1 if step else 0, *args, cur, n=n, rows=rows)
        for x, y in zip((*whole, *a), (*tiled, *b)):
            assert torch.equal(x, y)
        cur += 1


def test_sweep_converts_the_reference_planes_exactly():
    rng = np.random.default_rng(9)
    planes = (rng.integers(0, 1 << 16, (8, 16)).astype(np.uint16),
              rng.integers(0, 1 << 16, (8, 16)).astype(np.uint16),
              rng.integers(0, 1 << 32, (8, 16), dtype=np.uint64).astype(np.uint32))
    dev = pk.planes_to_device(*planes, "cpu")
    assert [p.dtype for p in dev] == [torch.int16, torch.int16, torch.int32]
    for a, b in zip(planes, pk.planes_from_device(dev)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(empty_planes_np(4, 8), pk.planes_from_device(pk.empty_planes(4, 8, "cpu"))):
        np.testing.assert_array_equal(a, b)


def test_sweep_records_the_reference_obligations():
    from lighthouse_tpu_torch.ops.bls import fq

    seen = []

    class Sink:
        def record(self, kind, proven, limit, note="", ok=True):
            seen.append((kind, ok))

    prev, fq._CERT_SINK = fq._CERT_SINK, Sink()
    try:
        pk.sweep_(pk.empty_planes(4, 32, "cpu"), 0, [1], [3], [4], np.array([7], np.uint32),
                  [True], 10, n=32)
    finally:
        fq._CERT_SINK = prev
    assert {k for k, ok in seen if ok} >= {
        "slasher_distance_width", "slasher_target_domain", "slasher_window_width"}
    assert all(ok for _, ok in seen)
    with pytest.raises(fq.BoundError):
        pk.sweep_(pk.empty_planes(4, 8, "cpu"), 0, [], [], [], [], [], 10, n=(1 << 16) + 1)


# =============================================================================
# the seed row update and the DB-backed seed path
# =============================================================================


def test_row_update_equals_reference():
    """``_rows_update`` through ``update_rows``: stacks of rows at different
    stored epochs (a window wrap among them), random pairs; the new tiles and
    every (flag, target) read equal the reference's."""
    from lighthouse_tpu.slasher.arrays import empty_row
    from lighthouse_tpu.slasher.arrays import update_rows as r_update

    from lighthouse_tpu_torch.slasher.arrays import update_rows as p_update

    rng = np.random.default_rng(17)
    k, n = 8, 32
    rows = [(0, *empty_row(k, n))]
    for _ in range(2):
        r, _ = r_update(rows[:1], [[(0, 3, 5)]], 6, n)
        rows.append((6, *r[0]))
    rows[2] = (40, rows[2][1], rows[2][2])  # stored far back: the window wraps
    for cur in (10, 12, 50):
        pairs = []
        for _ in rows:
            ps = []
            for _ in range(int(rng.integers(1, 9))):
                t = int(rng.integers(max(0, cur - n + 2), cur + 1))
                ps.append((int(rng.integers(0, k)), int(rng.integers(max(0, cur - n + 2), t + 1)), t))
            pairs.append(ps)
        r_rows, r_res = r_update(rows, pairs, cur, n)
        p_rows, p_res = p_update(rows, pairs, cur, n, device="cpu")
        assert p_res == r_res
        for (a0, a1), (b0, b1) in zip(r_rows, p_rows):
            assert b0.dtype == np.uint16
            np.testing.assert_array_equal(a0, b0)
            np.testing.assert_array_equal(a1, b1)
        rows = [(cur, *r) for r in r_rows]


def _seed_pair(chunk=16, history=64):
    return (RSlasher(RStore(), R_NS, RConfig(validator_chunk_size=chunk, history_length=history)),
            PSlasher(PStore(), P_NS, PConfig(validator_chunk_size=chunk, history_length=history)))


def _same_db(r, p):
    assert p.db.store._data == r.db.store._data


# the streams of tests/test_slasher.py::TestSlasher, on both packages
SEED_STREAMS = {
    "not_slashable": [[([1, 2, 3], 4, 5, 0), ([1, 2, 3], 5, 6, 0)], 6],
    "double_vote": [[([7], 4, 5, 1), ([7], 4, 5, 2)], 6],
    "surround_within_batch": [[([5], 10, 11, 0), ([5], 9, 12, 0)], 12],
    "shared_target": [[([2], 4, 5, 0), ([2], 4, 5, 0)], 6],
}


@pytest.mark.parametrize("name", sorted(SEED_STREAMS))
def test_seed_slasher_equals_reference(name):
    atts, epoch = SEED_STREAMS[name]
    r, p = _seed_pair()
    for v, s, t, seed in atts:
        r.accept_attestation(_att("r", v, s, t, seed))
        p.accept_attestation(_att("p", v, s, t, seed))
    assert p.process_queued(epoch) == r.process_queued(epoch)
    assert _keys(p.get_attester_slashings()) == _keys(r.get_attester_slashings())
    _same_db(r, p)


def test_seed_slasher_across_batches_and_pruning():
    """Surrounds in both directions across batches, a deferred and a dropped
    attestation, a proposer double vote, pruning: the same stats, slashings
    and KV rows (compressed target tiles included) batch by batch."""
    r, p = _seed_pair()
    steps = [
        ([([3], 10, 11, 0), ([4], 9, 12, 0)], [], 12),
        ([([3], 9, 12, 0), ([4], 10, 11, 0), ([1], 100, 101, 0), ([1], 1, 2, 0)],
         [(8, 3, 1), (8, 3, 2), (8, 4, 1)], 90),
        ([], [], 101),
    ]
    for atts, headers, epoch in steps:
        for v, s, t, seed in atts:
            r.accept_attestation(_att("r", v, s, t, seed))
            p.accept_attestation(_att("p", v, s, t, seed))
        for slot, prop, body in headers:
            r.accept_block_header(_header("r", slot, prop, body))
            p.accept_block_header(_header("p", slot, prop, body))
        assert p.process_queued(epoch) == r.process_queued(epoch)
        assert _keys(p.get_attester_slashings()) == _keys(r.get_attester_slashings())
        assert _keys(p.get_proposer_slashings()) == _keys(r.get_proposer_slashings())
        _same_db(r, p)
    assert p.prune_database(500, 8) == r.prune_database(500, 8)
    _same_db(r, p)


def test_seed_slasher_16k_validators():
    """tests/test_slasher.py's 16k-validator stream: many rows, one far-row
    surround and one double vote, the same slashings and KV rows."""
    cfg = dict(chunk=256, history=256)
    r, p = _seed_pair(**cfg)
    rng = np.random.default_rng(3)
    batches = [[(rng.choice(16384, size=64, replace=False), e, e + 1, e) for e in range(20, 30)]
               + [([16000], 25, 26, 25), ([123], 28, 29, 28)],
               [([16000], 19, 31, 99), ([123], 28, 29, 98)]]
    for batch in batches:
        for v, s, t, seed in batch:
            r.accept_attestation(_att("r", v, s, t, seed))
            p.accept_attestation(_att("p", v, s, t, seed))
        assert p.process_queued(31) == r.process_queued(31)
        assert _keys(p.get_attester_slashings()) == _keys(r.get_attester_slashings())
    _same_db(r, p)


# =============================================================================
# the engine: detection, checkpoints, the fault drill
# =============================================================================


def _engines(backend="device", **kw):
    cfg = dict(validator_chunk_size=16, history_length=64)
    return (r_make(None, R_NS, RConfig(**cfg), backend="numpy"),
            p_make(None, P_NS, PConfig(**cfg), backend=backend, **kw))


def _stream(seed, n_events=40, v_cap=48):
    """tests/test_slasher_engine.py::TestSeedPathParity's stream."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_events):
        t = int(rng.integers(2, 31))
        s = int(rng.integers(max(0, t - 8), t + 1))
        v = rng.choice(v_cap, size=int(rng.integers(1, 4)), replace=False)
        out.append((v, s, t, int(rng.integers(0, 4))))
    return out


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_engine_equals_reference_on_streams(backend):
    """The engine on its torch sweep (and on its numpy twin) emits the
    reference engine's slashings on the sequential and the batched streams,
    with the same stats and planes."""
    r, p = _engines(backend)
    for v, s, t, seed in _stream(3):
        r.accept_attestation(_att("r", v, s, t, seed))
        p.accept_attestation(_att("p", v, s, t, seed))
        assert p.process_queued(30) == r.process_queued(30)
        assert _keys(p.get_attester_slashings()) == _keys(r.get_attester_slashings())
    for v, s, t, seed in _stream(5):
        r.accept_attestation(_att("r", v, s, t, seed))
        p.accept_attestation(_att("p", v, s, t, seed))
    assert p.process_queued(31) == r.process_queued(31)
    found = _keys(p.get_attester_slashings())
    assert found and found == _keys(r.get_attester_slashings())
    for a, b in zip(r.span.planes(), p.span.planes()):
        np.testing.assert_array_equal(a, b)
    assert p.span.mode == ("device" if backend == "device" else "host")
    assert p.stats()["demotions"] == 0


def test_engine_checkpoint_bytes_and_cross_restore():
    """The engine's checkpoint equals the reference's byte for byte (records,
    planes, pending slashings); a reference checkpoint restores in the port
    and the port's in the reference, and both convict a post-restart double
    vote and surround against a pre-restart vote."""
    r, p = _engines()
    for v, s, t, seed in [([1, 2, 3], 2, 4, 17), ([9], 3, 5, 1), ([9], 3, 5, 2)]:
        r.accept_attestation(_att("r", v, s, t, seed))
        p.accept_attestation(_att("p", v, s, t, seed))
    r.process_queued(5)
    p.process_queued(5)
    rs, ps = RStore(), PStore()
    assert r.persist(rs) and p.persist(ps)
    p_blob = ps.get(PCol.SlasherMeta, EngineSlasher.PERSIST_KEY)
    r_blob = rs.get(RCol.SlasherMeta, EngineSlasher.PERSIST_KEY)
    assert p_blob == r_blob

    rs2, ps2 = RStore(), PStore()
    rs2.put(RCol.SlasherMeta, EngineSlasher.PERSIST_KEY, p_blob)
    ps2.put(PCol.SlasherMeta, EngineSlasher.PERSIST_KEY, r_blob)
    cfg = dict(validator_chunk_size=16, history_length=64)
    r2 = r_make(rs2, R_NS, RConfig(**cfg), backend="numpy")
    p2 = p_make(ps2, P_NS, PConfig(**cfg), backend="device")
    assert len(p2._atts) == len(r2._atts) == 3 and p2.span.mode == "device"
    assert _keys(p2.get_attester_slashings()) == _keys(r2.get_attester_slashings()) != []
    for v, s, t, seed in [([2], 2, 4, 99), ([3], 1, 6, 77)]:
        r2.accept_attestation(_att("r", v, s, t, seed))
        p2.accept_attestation(_att("p", v, s, t, seed))
    stats = p2.process_queued(6)
    assert stats == r2.process_queued(6)
    assert stats["double_vote_slashings"] == 1 and stats["surround_slashings"] == 1
    assert _keys(p2.get_attester_slashings()) == _keys(r2.get_attester_slashings())
    p2.persist(ps2)
    r2.persist(rs2)
    assert ps2.get(PCol.SlasherMeta, EngineSlasher.PERSIST_KEY) == rs2.get(
        RCol.SlasherMeta, EngineSlasher.PERSIST_KEY)


def test_fault_drill_demotes_losslessly_and_repromotes():
    """A corruption-classified ``slasher.sweep`` demotes the store: the host
    checkpoint plus the journal replayed through the numpy twin give planes
    equal to an unfaulted run, the surround lands anyway, the demotion is
    counted and noted; after probation the planes go back to the device."""
    twin = p_make(None, P_NS, PConfig(validator_chunk_size=16, history_length=64),
                  backend="numpy")
    sup = slasher_supervisor()
    prev = sup.config.probation_s
    sup.config.probation_s = 0.0
    try:
        injector.install("stage=slasher.sweep;mode=corrupt;at=3;times=1")
        s = p_make(None, P_NS, PConfig(validator_chunk_size=16, history_length=64),
                   backend="device", checkpoint_every=2)
        for e in (s, twin):
            e.accept_attestation(_att("p", [3], 10, 11))
            e.process_queued(12)
            e.accept_attestation(_att("p", [4], 11, 12))
            e.process_queued(12)  # the device store checkpoints here
            e.accept_attestation(_att("p", [3], 9, 12))  # faulted on the device
            assert e.process_queued(13)["surround_slashings"] == 1
        assert s.span.mode == "host" and s.span.demotions == 1
        assert sup.snapshot()["fallback_calls"] >= 1
        for a, b in zip(s.span.planes(), twin.span.planes()):
            np.testing.assert_array_equal(a, b)
        assert len(s.get_attester_slashings()) == 1
        for e in (s, twin):
            e.accept_attestation(_att("p", [6], 12, 13))
            e.process_queued(14)
        assert s.span.mode == "device" and s.span.promotions == 1
        for a, b in zip(s.span.planes(), twin.span.planes()):
            np.testing.assert_array_equal(a, b)
    finally:
        sup.config.probation_s = prev


def test_interrupted_sweep_is_corruption_not_a_retry():
    """A sweep that fails after writing the planes in place raises
    ``PlanesIndeterminate`` (classified corruption, never retried on the
    half-written planes); the store demotes and replays."""
    from lighthouse_tpu_torch.resilience import faults

    s = SpanStore(64, use_device=True, device="cpu", checkpoint_every=100)
    s.apply(np.array([1]), np.array([4]), np.array([5]), np.array([1], np.uint32), 6)
    real = pk._advance_

    def boom(*a, **k):
        real(*a, **k)
        raise RuntimeError("lost mid-sweep")

    pk._advance_ = boom
    try:
        s.apply(np.array([1]), np.array([3]), np.array([7]), np.array([2], np.uint32), 7)
    finally:
        pk._advance_ = real
    assert faults.classify(pk.PlanesIndeterminate("x")) == faults.FaultKind.CORRUPTION
    assert s.mode == "host" and s.demotions == 1 and slasher_supervisor().retries == 0
    twin = SpanStore(64, use_device=False)
    twin.apply(np.array([1]), np.array([4]), np.array([5]), np.array([1], np.uint32), 6)
    twin.apply(np.array([1]), np.array([3]), np.array([7]), np.array([2], np.uint32), 7)
    for a, b in zip(s.planes(), twin.planes()):
        np.testing.assert_array_equal(a, b)


def test_backend_seam():
    """"device" and "numpy" only (no "auto", no environment variable); the
    default device is CUDA and raises without it."""
    for bad in ("auto", "tpu"):
        with pytest.raises(ValueError):
            p_slasher.set_backend(bad)
        with pytest.raises(ValueError):
            EngineSlasher(None, P_NS, PConfig(history_length=64), backend=bad)
    p_slasher.set_backend("numpy")
    s = p_make(None, P_NS, PConfig(history_length=64))
    assert not p_slasher.device_backend_active() and s.span.use_device is False
    p_slasher.set_backend("device")
    assert p_slasher.get_device() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p_make(None, P_NS, PConfig(history_length=64))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PSlasher(PStore(), P_NS, PConfig(history_length=64))
    s = p_make(None, P_NS, PConfig(history_length=64), device="cpu")
    assert s.span.device == torch.device("cpu") and s.stats()["backend"] == "device"
    # no config: the reference's 4096-epoch window
    assert p_make(None, P_NS, device="cpu").config.history_length == 4096


def test_fresh_store_allocates_no_host_planes():
    s = SpanStore(128, use_device=True, device="cpu")
    s.ensure_capacity(5000)
    assert s.n_pad == 8192 and s.dev[0].shape == (8192, 128)
    assert not isinstance(s.host, list)  # fresh planes: their shape only
    for a, b in zip(s.planes(), empty_planes_np(8192, 128)):
        np.testing.assert_array_equal(a, b)


def test_service_feeds_op_pool_on_both_packages():
    class PoolStub:
        def __init__(self):
            self.att, self.prop = [], []

        def insert_attester_slashing(self, s):
            self.att.append(s)

        def insert_proposer_slashing(self, s):
            self.prop.append(s)

    from lighthouse_tpu.types.spec import minimal_spec as r_spec

    from lighthouse_tpu_torch.types.spec import minimal_spec as p_spec

    pools = []
    for pkg, svc_cls, make, cfg, spec in (("r", RService, r_make, RConfig, r_spec),
                                          ("p", PService, p_make, PConfig, p_spec)):
        pool = PoolStub()
        chain = type("ChainStub", (), {"op_pool": pool, "spec": spec()})()
        kw = {"backend": "numpy"} if pkg == "r" else {}
        svc = svc_cls(chain, make(None, R_NS if pkg == "r" else P_NS,
                                  cfg(validator_chunk_size=16, history_length=64), **kw), pool)
        svc.attestation_observed(_att(pkg, [3], 10, 11))
        svc.tick(current_epoch=12)
        svc.attestation_observed(_att(pkg, [3], 9, 12))
        svc.tick(current_epoch=12)
        pools.append(pool)
    assert len(pools[1].att) == 1 and _keys(pools[0].att) == _keys(pools[1].att)
