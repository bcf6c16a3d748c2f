"""The port's batched KZG cell engine against the reference's pieces.

Bottom-up: the port's bare convolution against the reference's digit
convolution; its Fr limb ops (``ops/kzg/frops``) against the reference's
under ``LIGHTHOUSE_CONV_IMPL=digits``, on random and edge inputs, and every
``kzg.*`` certificate raising past its bound; ``curve.scale_bits`` on G1 and
G2 against the reference's; ``interpolate_rows`` and the engine's tables
against the reference's (carried across with ``convert``; the reference's
coset-shift G2 chains are stood in for by its oracle, whose compile would
take minutes here); the RLC transcript weights; the engine's verdicts on
``device="cpu"`` (the kernels' plain versions) against the reference's
host ``CellContext`` loop; the run-time ``PROBE`` counts; the single-cell
path; and the ``kzg_device`` ladder, which on a card has no host rung and
fails closed. Exact equality everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.kzg import engine as r_engine
from lighthouse_tpu.kzg.cells import CellContext as RCellContext
from lighthouse_tpu.kzg.fr import bls_field_to_bytes
from lighthouse_tpu.kzg.kzg import Kzg as RKzg
from lighthouse_tpu.kzg.setup import insecure_setup
from lighthouse_tpu.ops.bls import chain_plans as r_chain_plans
from lighthouse_tpu.ops.bls import curve as r_curve
from lighthouse_tpu.ops.bls import fq as r_fq
from lighthouse_tpu.ops.bls import g1 as r_g1
from lighthouse_tpu.ops.bls import g2 as r_g2
from lighthouse_tpu.ops.bls_oracle import curves as r_oc
from lighthouse_tpu.ops.kzg import frops as r_frops
from lighthouse_tpu.ops.kzg import verify as r_verify
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert, resilience
from lighthouse_tpu_torch.kzg import engine
from lighthouse_tpu_torch.kzg.cells import CellContext as PCellContext
from lighthouse_tpu_torch.kzg.kzg import Kzg as PKzg
from lighthouse_tpu_torch.ops.bls import chain_plans as p_chain_plans
from lighthouse_tpu_torch.ops.bls import curve as p_curve
from lighthouse_tpu_torch.ops.bls import fq as p_fq
from lighthouse_tpu_torch.ops.bls import g1 as p_g1
from lighthouse_tpu_torch.ops.bls import g2 as p_g2
from lighthouse_tpu_torch.ops.bls import tower as p_tower
from lighthouse_tpu_torch.ops.kzg import frops as p_frops
from lighthouse_tpu_torch.ops.kzg import verify as p_verify
from lighthouse_tpu_torch.oracle.fields import P, R, Fq2
from lighthouse_tpu_torch.resilience.inject import injector
from lighthouse_tpu_torch.resilience.supervisor import SupervisorConfig

# the reference engine tests' geometry: nontrivial cosets, cheap plain versions
N = 16
CELLS = 8
K = 2 * N // CELLS
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), p_bls.get_backend(), p_bls.get_device(),
             engine.get_kzg_backend(), engine.get_kzg_device())
    r_bls.set_backend("oracle")
    p_bls.set_backend("oracle")
    yield
    r_bls.set_backend(saved[0])
    p_bls.set_backend(saved[1], device=saved[2])
    engine.set_kzg_backend(saved[3], device=saved[4])


@pytest.fixture
def digits(monkeypatch):
    """The reference's conv seam on its digit arm (the port's arm)."""
    monkeypatch.setenv("LIGHTHOUSE_CONV_IMPL", "digits")
    monkeypatch.setattr(r_fq, "_CONV_IMPL", None)
    yield


@pytest.fixture(scope="module")
def env():
    rkzg = RKzg(insecure_setup(N, n_g2=K + 1))
    rctx = RCellContext(rkzg, cells_per_ext_blob=CELLS)
    pctx = PCellContext(PKzg(convert.trusted_setup_from_ref(rkzg.setup)), cells_per_ext_blob=CELLS,
                        msm_backend="host")
    rng = np.random.default_rng(21)
    blob = b"".join(bls_field_to_bytes(int(rng.integers(1, 2**62))) for _ in range(N))
    commitment = rctx.kzg.blob_to_kzg_commitment(blob)
    cells, proofs = rctx.compute_cells_and_kzg_proofs(blob)
    assert pctx.kzg.blob_to_kzg_commitment(blob) == commitment
    assert pctx.compute_cells_and_kzg_proofs(blob) == (cells, proofs)
    return rctx, pctx, commitment, cells, proofs


@pytest.fixture(scope="module")
def eng(env):
    engine.set_kzg_backend("device", device="cpu")
    return engine.get_engine(env[1])


@pytest.fixture(scope="module")
def ref_tables(env):
    """The reference's VerifyTables from its own _build_tables, its
    coset-shift chains run by its oracle instead of its compiled walk."""
    rctx = env[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_chain_plans, "compile_chains", lambda scalars, *a, **k: tuple(scalars))
        mp.setattr(r_chain_plans, "run_point_chains", lambda k, pts, scalars: jnp.stack(
            [r_g2.from_oracle(r_oc.g2_mul(r_oc.g2_generator(), s % R)) for s in scalars]))
        return r_engine.CellEngine(rctx)._build_tables()


def _to_ints(limbs):
    return [p_frops.limbs_to_fr(row) for row in np.asarray(limbs)]


def _rand_fr(rng, n):
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def _both(vals):
    """Limb rows of ``vals`` for the reference (uint64) and the port (int64)."""
    a = p_frops.fr_to_limbs(vals)
    return jnp.asarray(a.astype(np.uint64)), torch.from_numpy(a)


# -- the conv entry and the Fr limb ops ---------------------------------------------


def test_conv_product_equals_the_reference_digit_conv():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 16, (6, 25))
    b = rng.integers(0, 1 << 16, (6, 25))
    a[0] = b[0] = 0xFFFF  # every limb at the 16-bit maximum
    a[1] = 0
    a[2] = b[3] = (1 << 22) - 1  # the lazy budget's limb maximum
    want = np.asarray(r_fq._conv_product_digits(jnp.asarray(a.astype(np.uint64)),
                                                jnp.asarray(b.astype(np.uint64))))
    got = p_fq.conv_product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want.astype(np.int64))


def test_conv_limb_bounds_equal_the_reference_and_raise(digits):
    for lim in (0xFFFF, (1 << 22) - 1):
        assert p_fq.conv_limb_bounds(lim) == r_fq.conv_limb_bounds(lim)
    with pytest.raises(p_fq.BoundError, match="conv_digit"):
        p_fq.conv_limb_bounds(1 << 44)


def test_fr_ops_equal_the_reference(digits):
    rng = np.random.default_rng(2)
    a = [R - 1, 0, 1, R - 1] + _rand_fr(rng, 6)
    b = [R - 1, R - 1, 1, 0] + _rand_fr(rng, 6)
    (ra, pa), (rb, pb) = _both(a), _both(b)
    got = _to_ints(p_frops.fr_mul(pa, pb))
    assert got == _to_ints(jax.jit(r_frops.fr_mul)(ra, rb)) == [x * y % R for x, y in zip(a, b)]
    # dot over K = 5 and a broadcast operand
    la, lb = p_frops.fr_to_limbs(a[:10]).reshape(2, 5, 25), p_frops.fr_to_limbs(b[5:10])
    want = _to_ints(jax.jit(r_frops.fr_dot)(jnp.asarray(la.astype(np.uint64)),
                                            jnp.asarray(lb.astype(np.uint64))[None]))
    got = _to_ints(p_frops.fr_dot(torch.from_numpy(la), torch.from_numpy(lb)[None]))
    assert got == want == [sum(x * y for x, y in zip(a[5 * i:5 * i + 5], b[5:10])) % R
                           for i in range(2)]
    w = p_frops.fr_to_limbs(a[:6]).reshape(3, 2, 25)
    u = p_frops.fr_to_limbs(b[:6]).reshape(3, 2, 25)
    want = _to_ints(jax.jit(r_frops.fr_weighted_sum, static_argnums=2)(
        jnp.asarray(w.astype(np.uint64)), jnp.asarray(u.astype(np.uint64)), 3))
    got = _to_ints(p_frops.fr_weighted_sum(torch.from_numpy(w), torch.from_numpy(u), 3))
    assert got == want
    bits = p_frops.fr_bits(pa)
    assert bits.shape == (255, len(a))
    assert np.array_equal(bits.numpy(), np.asarray(r_frops.fr_bits(ra)).astype(np.int64))


def test_fr_reduction_walk_equals_the_reference_on_all_ones_limbs(digits):
    """All sixteen low limbs at 0xFFFF (2^256 - 1, outside the canonical
    domain): the same fold/normalize/subtract walk, limb for limb."""
    x = np.zeros((2, 25), dtype=np.int64)
    x[:, :16] = 0xFFFF
    x[1, 0] = 0
    want = np.asarray(jax.jit(r_frops.fr_mul)(jnp.asarray(x.astype(np.uint64)),
                                              jnp.asarray(x.astype(np.uint64))))
    got = p_frops.fr_mul(torch.from_numpy(x), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("case", ["dot", "wsum", "reduce_in", "reduce_fold"])
def test_fr_certificates_raise_past_their_bounds(case):
    one = torch.zeros((1, 25), dtype=torch.int64)
    with pytest.raises(p_fq.BoundError, match="kzg"):
        # 2^40 summed products exceed int64; the certificate raises before
        # anything is allocated (the operands are zero-stride views)
        if case == "dot":
            p_frops.fr_dot(one.expand(1 << 40, 25), one.expand(1 << 40, 25))
        elif case == "wsum":
            big = one.expand(1 << 40, 25)
            p_frops.fr_weighted_sum(big, big, 1 << 40)
        elif case == "reduce_in":
            p_frops.fr_wide_reduce(one, 1 << 700)
        else:  # a fold step whose limbs would overflow int64
            p_frops.fr_wide_reduce(torch.zeros((1, 41), dtype=torch.int64), (1 << 640) * (1 << 62))


# -- scale_bits ------------------------------------------------------------------------


def _affine(k: int, limbs):
    """Projective limbs [3k, 25] (either package) -> affine ints, or None
    for infinity: one host inversion, no device graph."""
    c = [p_fq.limbs_to_int(np.asarray(row, dtype=np.int64)) % P for row in np.asarray(limbs)]
    if k == 1:
        x, y, z = c
        if z == 0:
            return None
        zi = pow(z, P - 2, P)
        return (x * zi % P, y * zi % P)
    x, y, z = Fq2(c[0], c[1]), Fq2(c[2], c[3]), Fq2(c[4], c[5])
    if z == Fq2(0, 0):
        return None
    zi = z.inv()
    return tuple(v for f in (x * zi, y * zi) for v in (f.c0, f.c1))


@pytest.mark.parametrize("k", [1, 2])
def test_scale_bits_equals_the_reference(k):
    """MSB-first ladders with zero-bit columns and an infinity lane."""
    rng = np.random.default_rng(3 + k)
    gen, mul, ref_mod, port_mod = (
        (r_oc.g1_generator(), r_oc.g1_mul, r_g1, p_g1) if k == 1
        else (r_oc.g2_generator(), r_oc.g2_mul, r_g2, p_g2))
    pts = [gen, None, mul(gen, 5), mul(gen, 77)]
    bits = rng.integers(0, 2, (8, 4))
    bits[:, 2] = 0
    bits[0, :] = 1
    ref = r_curve.scale_bits(k, ref_mod.from_oracle_batch(pts), jnp.asarray(bits.astype(np.uint64)))
    got = p_curve.scale_bits(k, port_mod.from_oracle_batch(pts, CPU), torch.from_numpy(bits))
    for j in range(4):
        scalar = int("".join(str(int(b)) for b in bits[:, j]), 2)
        want = None if pts[j] is None or scalar == 0 else mul(pts[j], scalar)
        if want is not None:
            want = want if k == 1 else (want[0].c0, want[0].c1, want[1].c0, want[1].c1)
        assert _affine(k, got[j].numpy()) == _affine(k, np.asarray(ref[j])) == want, j


# -- tables, interpolation and the transcript ----------------------------------------


def test_tables_equal_the_reference_and_the_oracle(env, eng, ref_tables):
    rctx, pctx = env[0], env[1]
    port = eng.tables()
    ref = convert.verify_tables_from_ref(ref_tables, CPU)
    for name, a, b in zip(p_verify.VerifyTables._fields, port, ref):
        assert a.dtype == b.dtype == torch.int64 and torch.equal(a, b), name
    # the coset-shift table [tau^k - d_i]G2, from the chain walk, against the oracle
    x, y = p_curve.to_affine(2, eng.z2_tab)
    tau_k = rctx.kzg.setup.g2_monomial[K]
    for i in range(CELLS):
        d = pow(pctx._coset_base(pctx.coset_points(i)), K, R)
        want = r_oc.g2_add(tau_k, r_oc.g2_neg(r_oc.g2_mul(r_oc.g2_generator(), d)))
        got = p_tower.to_ints(p_tower.t_canon(x[i])) + p_tower.to_ints(p_tower.t_canon(y[i]))
        assert got == [want[0].c0, want[0].c1, want[1].c0, want[1].c1], i
    assert eng.table_bytes() > 0 and eng.table_build_s > 0 and eng.z2_build_s > 0


def test_coset_shift_table_is_built_on_first_use(env, monkeypatch):
    """The batch tables leave the coset-shift table unbuilt (only the
    single-cell check reads it): no G2 chain runs, and the table bytes are
    the batch tables' alone."""
    def no_chains(*args):
        raise AssertionError("the coset-shift chains ran with the batch tables")

    monkeypatch.setattr(p_chain_plans, "run_point_chains", no_chains)
    fresh = engine.CellEngine(env[1], "cpu")
    tables = fresh.tables()
    assert fresh._z2_tab is None and fresh.z2_build_s is None
    assert fresh.table_bytes() == sum(t.numel() * t.element_size() for t in tables)


def test_interpolate_rows_equals_the_reference(env, eng, ref_tables, monkeypatch):
    rng = np.random.default_rng(5)
    v = p_frops.fr_to_limbs(_rand_fr(rng, 3 * K)).reshape(3, K, 25)
    want = np.asarray(jax.jit(functools.partial(r_verify.interpolate_rows, ref_tables))(
        jnp.asarray(v.astype(np.uint64))))
    got = p_verify.interpolate_rows(eng.tables(), torch.from_numpy(v))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # chunks of one (cell, row), of two cells by one row (the last chunk
    # ragged), of three cells by two rows
    per = K * 51 * 51
    for cap in (1, 2 * per, 6 * per):
        monkeypatch.setattr(p_verify, "_INTERP_ELEMS", cap)
        assert torch.equal(p_verify.interpolate_rows(eng.tables(), torch.from_numpy(v)), got)


def test_rlc_weights_equal_the_reference(env, eng):
    rctx, _, commitment, cells, proofs = env
    args = ([commitment] * 4, [0, 1, 2, 5], cells[:4], proofs[:4])
    w = eng._rlc_weights(*args)
    assert w == r_engine.get_engine(rctx)._rlc_weights(*args)
    assert all(0 < x < R for x in w)
    assert w != eng._rlc_weights([commitment] * 4, [0, 1, 2, 6], cells[:4], proofs[:4])


# -- engine verdicts on the CPU ------------------------------------------------------


def _tampered(cells, i):
    bad = bytearray(cells[i])
    bad[7] ^= 1
    return cells[:i] + [bytes(bad)] + cells[i + 1:]


def test_engine_verdicts_equal_the_reference_loop(env, eng):
    rctx, _, c, cells, proofs = env
    idx = list(range(CELLS))
    sel = [0, 2, 5]
    cases = [
        ("valid", [c] * CELLS, idx, cells, proofs, True),
        ("tampered cell", [c] * CELLS, idx, _tampered(cells, 3), proofs, False),
        ("n=3 padded to 4", [c] * 3, sel, [cells[i] for i in sel], [proofs[i] for i in sel], True),
        ("empty", [], [], [], [], True),
        ("malformed commitment", [b"\x00" * 48] * 2, [0, 1], cells[:2], proofs[:2], False),
        ("index out of range", [c], [CELLS + 3], cells[:1], proofs[:1], False),
        ("ragged lengths", [c] * 2, [0], cells[:2], proofs[:2], False),
    ]
    for name, comms, ix, cl, pr, want in cases:
        before = dict(p_verify.PROBE)
        assert rctx.verify_cell_kzg_proof_batch(comms, ix, cl, pr) is want, name
        assert eng.verify_batch(comms, ix, cl, pr) is want, name
        ran = {k: p_verify.PROBE[k] - before[k] for k in before}
        device_run = name in ("valid", "tampered cell", "n=3 padded to 4")
        # one pairing check with two pairs and one scale ladder per batch
        assert ran == ({"pairing_checks": 1, "pairs": 2, "scale_scans": 1} if device_run
                       else {"pairing_checks": 0, "pairs": 0, "scale_scans": 0}), name


def test_single_cell_path(env, eng):
    rctx, _, c, cells, proofs = env
    assert eng.verify_cell(c, 3, cells[3], proofs[3]) is rctx.verify_cell_kzg_proof(
        c, 3, cells[3], proofs[3]) is True
    assert eng.verify_cell(c, 4, cells[3], proofs[3]) is rctx.verify_cell_kzg_proof(
        c, 4, cells[3], proofs[3]) is False
    assert eng.verify_cell(c, CELLS, cells[3], proofs[3]) is False
    assert eng.verify_cell(c[:47], 3, cells[3], proofs[3]) is False


def test_non_canonical_cell_is_a_false_verdict_not_a_fault(env, kzg_sup):
    """A cell holding a field element >= r: the reference's host loop lets
    the parser's ValueError escape (and its device engine, catching only
    KzgError, takes it for a rung fault); the port's host loop, engine and
    ladder all answer False, and the supervisor records no fault."""
    rctx, pctx, c, cells, proofs = env
    bad = R.to_bytes(32, "big") + cells[0][32:]
    with pytest.raises(ValueError, match="non-canonical"):
        rctx.verify_cell_kzg_proof(c, 0, bad, proofs[0])
    assert pctx.verify_cell_kzg_proof(c, 0, bad, proofs[0]) is False
    engine.set_kzg_backend("device", device="cpu")
    eng = engine.get_engine(pctx)
    assert eng.verify_batch([c, c], [0, 1], [bad, cells[1]], proofs[:2]) is False
    assert eng.verify_cell(c, 0, bad, proofs[0]) is False
    assert engine.verify_cell_proof_batch(pctx, [c], [0], [bad], proofs[:1]) is False
    snap = kzg_sup.snapshot()
    assert snap["faults"] == 0 and snap["fallback_calls"] == 0, snap


# -- the kzg_device ladder ------------------------------------------------------------


@pytest.fixture
def kzg_sup():
    sup = resilience.kzg_supervisor()
    saved = sup.config
    sup.config = SupervisorConfig(deadline_s=600.0, max_retries=1, backoff_base_s=0.001,
                                  backoff_max_s=0.005, promote_after=1, probe_every=1,
                                  probation_s=60.0)
    sup.reset()
    yield sup
    injector.clear()
    sup.config = saved
    sup.reset()


def test_device_full_fault_gives_the_same_verdict_from_device_reduced(env, eng, kzg_sup):
    rctx, pctx, c, cells, proofs = env
    engine.set_kzg_backend("device", device="cpu")
    injector.install("stage=kzg.cell_batch_verify;mode=raise;every=1")
    idx = [0, 1, 4, 6]
    args = ([c] * 4, idx, [cells[i] for i in idx], [proofs[i] for i in idx])
    assert engine.verify_cell_proof_batch(pctx, *args) is True
    bad = (args[0], args[1], _tampered(args[2], 2), args[3])
    assert engine.verify_cell_proof_batch(pctx, *bad) is rctx.verify_cell_kzg_proof_batch(*bad) is False
    snap = kzg_sup.snapshot()
    assert snap["faults"] >= 2 and snap["exhausted"] == 0, snap
    assert snap["fallback_calls"] >= 2, snap


def test_fully_faulted_ladder_fails_closed(env, kzg_sup):
    _, pctx, c, cells, proofs = env
    engine.set_kzg_backend("device", device="cpu")
    injector.install("stage=kzg.cell_batch_verify*;mode=raise;every=1")
    assert engine.verify_cell_proof_batch(pctx, [c] * CELLS, list(range(CELLS)), cells, proofs) is False
    assert kzg_sup.snapshot()["exhausted"] >= 1


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_device_ladder_fails_closed_off_the_cpu(env, kzg_sup, monkeypatch, where):
    """An engine whose device verify faults on every call: on the CPU the
    ladder's cpu_oracle rung (the host loop) answers; on any other device (a
    card; the meta device stands in for one here) the ladder ends at
    device_reduced and the batch fails closed, the host loop never called."""
    _, pctx, c, cells, proofs = env
    engine.set_kzg_backend("device", device=where)
    eng = engine.get_engine(pctx)
    assert eng.device.type == where
    calls = []

    def faulting(*args):
        calls.append(("device", len(args[2])))
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")

    def host(*args, real=pctx.verify_cell_kzg_proof_batch):
        calls.append(("host", len(args[2])))
        return real(*args)

    monkeypatch.setattr(eng, "verify_batch", faulting)
    monkeypatch.setattr(pctx, "verify_cell_kzg_proof_batch", host)
    ok = engine.verify_cell_proof_batch(pctx, [c] * 4, [0, 1, 2, 3], cells[:4], proofs[:4])
    assert calls[:2] == [("device", 4), ("device", 2)]
    if where == "cpu":
        assert ok is True and calls[2:] == [("host", 4)]
    else:
        assert ok is False and len(calls) == 2


def test_backend_seam(env):
    _, pctx, c, cells, proofs = env
    with pytest.raises(ValueError, match="unknown kzg backend"):
        engine.set_kzg_backend("auto")
    engine.set_kzg_backend("host")
    assert not engine.device_backend_active()
    assert engine.verify_cell_proof_batch(pctx, [c] * 2, [0, 1], cells[:2], proofs[:2]) is True
    assert engine.verify_cell_proof_batch(pctx, [c], [0, 1], cells[:2], proofs[:2]) is False
    engine.set_kzg_backend("device")
    assert engine.device_backend_active() and engine.get_kzg_device() is None
    if not torch.cuda.is_available():
        # the default device is CUDA: without it the entry point raises
        # before any supervised region, never dropping to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.verify_cell_proof_batch(pctx, [c], [0], cells[:1], proofs[:1])
