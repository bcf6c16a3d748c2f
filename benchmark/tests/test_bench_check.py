"""The check that decides ``correct``: the reference's verdicts on known
valid and invalid sets, the control and each fault a cell can have coming
out not correct, and sound runs coming out correct."""

import pytest

from benchmark import run
from benchmark.harness import fixtures
from benchmark.reference import bls as rb
from benchmark.reference import curves as oc
from benchmark.reference.fields import R
from benchmark.tools import faults
from benchmark.tools.control import control_verifier

from .conftest import stand_in, tiny_cell

SK0 = 0x1D0C5EED0042
N = 1 << 8


@pytest.fixture(scope="module")
def reg():
    return fixtures.registry_walk((SK0, N))


def _sig(sk, msg):
    return oc.g2_compress(oc.g2_mul(rb.HashCache()(msg), sk % R))


def test_the_reference_judges_known_sets_at_2p8_keys(reg):
    h = rb.HashCache()
    m, other = b"\x11" * 32, b"\x22" * 32
    ix = (3, 17, 200, 255)
    agg_sk = len(ix) * SK0 + sum(ix)
    good = _sig(agg_sk, m)
    assert rb.verify_set(reg, ix, m, good, h)
    assert rb.verify_set(reg, (9,), m, _sig(SK0 + 9, m), h)
    assert not rb.verify_set(reg, ix, m, _sig(agg_sk, other), h)          # another message
    assert not rb.verify_set(reg, ix[:3], m, good, h)                      # another key set
    assert not rb.verify_set(reg, ix, m, _sig(agg_sk + 1, m), h)           # another key
    assert not rb.verify_set(reg, (), m, good, h)                          # no keys
    assert not rb.verify_set(reg, ix, m, bytes([0xC0]) + bytes(95), h)     # infinity
    assert not rb.verify_set(reg, ix, m, bytes(96), h)                     # not compressed
    bad_x = bytearray(good)
    bad_x[-1] ^= 1
    assert not rb.verify_set(reg, ix, m, bytes(bad_x), h)                  # off the curve or the subgroup
    # the control's judgement passes the signature over another message
    assert rb.well_formed_set(reg, ix, m, _sig(agg_sk, other), h)
    assert not rb.well_formed_set(reg, ix, m, bytes(96), h)


def test_the_fixture_signers_sign_what_the_reference_accepts(reg):
    h = rb.HashCache()
    m = b"\x33" * 32
    pairs = [(1, 5), (1, 250), (3, 1 + 2 + 3), (2, 255 + 254)]
    sigs = fixtures.sign_job(("shared", m, SK0, 4, N.bit_length() + 2, pairs))
    sets = [((5,), sigs[0]), ((250,), sigs[1]), ((1, 2, 3), sigs[2]), ((255, 254), sigs[3])]
    assert all(rb.verify_set(reg, ix, m, s, h) for ix, s in sets)
    (own,) = fixtures.sign_job(("distinct", [(SK0 + 77, b"\x44" * 32)]))
    assert rb.verify_set(reg, (77,), b"\x44" * 32, own, h)


def test_the_reference_judges_alike_in_worker_processes():
    import multiprocessing

    from benchmark.harness import check
    from benchmark.harness import traffic as tg

    cell = tiny_cell("aggregates", sample=3)
    traffic = tg.plan(cell.config, cell.params, 2**31 + 15, 2.0, workers=1)
    traffic.attach([fixtures.sign_job(j) for j in traffic.jobs])
    raw = fixtures.registry_walk((int(cell.config["base_secret_key"], 0), cell.config["validators"]))
    serial = check.reference_verdicts(traffic, raw)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        assert check.reference_verdicts(traffic, raw, pool, 2) == serial
    assert sorted(serial.values()) == [False, False, True, True, True]


def _run(kind, seed, **kw):
    kw.setdefault("verifier", stand_in)
    kw.setdefault("warm", False)
    return run.execute(tiny_cell(kind), seed, 2.0, False, device="cpu", workers=0, **kw)


@pytest.mark.parametrize("kind", ["aggregates", "attestations"])
def test_a_sound_verifier_comes_out_correct(kind):
    result, notes, _ = _run(kind, 2**31 + 11)
    assert result["correct"], notes
    assert notes[-3:] == [f"check {k}: 0 (limit 0)"
                          for k in ("wrong_verdicts", "unanswered", "invalid_unjudged")]
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("kind", ["aggregates", "attestations"])
def test_the_control_comes_out_not_correct(kind):
    result, notes, _ = _run(kind, 2**31 + 12, verifier=control_verifier)
    assert not result["correct"]
    assert result["check"]["wrong_verdicts"]["value"] >= 1, notes


FAULTS = [(k, f) for k in ("aggregates", "attestations") for f in faults.FAULTS]


@pytest.mark.parametrize("kind, fault", FAULTS, ids=[f"{k}-{f}" for k, f in FAULTS])
def test_each_fault_a_cell_can_have_comes_out_not_correct(kind, fault):
    """With the timed path broken underneath: a verify that returns without
    verifying, one that leaves either half of its batch out, and one whose
    answer is altered where it is produced. The aggregate mix's two invalid
    payloads are submitted half a batch apart, so they sit in opposite
    halves of one batch; the attestation mix's are spread at seeded
    positions over a stretch that several batches cover, so some sit in
    each half of theirs."""
    result, notes, _ = _run(kind, 2**31 + 13, wrap_verify=faults.FAULTS[fault])
    assert not result["correct"], notes


def test_the_program_on_the_cpu_comes_out_correct():
    """The whole run with the program itself underneath, on the CPU (its
    kernels' plain versions), at the small cell: warm-up, window, check."""
    result, notes, _ = _run("aggregates", 2**31 + 14, verifier=None, warm=True)
    assert result["correct"], notes
    assert "warm-up builds" in notes[1]


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    from benchmark.harness import spec

    import json

    for w in spec.benchmark()["workloads"]:
        rc = run.main(["--workload", w["name"], "--seed", str(2**31 + 21), "--seconds", "5"])
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0 and json.loads(out[-1])["correct"], w["name"]
