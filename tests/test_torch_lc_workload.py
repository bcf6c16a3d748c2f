"""The port's light-client session fabricator against the reference's.

``lighthouse_tpu_torch.testing.lc_workload`` is the port's copy of
``lighthouse_tpu/testing/lc_workload.py``: optimistic-update sessions with
real sync-committee aggregate signatures over synthetic headers, drawn
from a seed. Both packages' ``StateHarness`` (minimal, altair from
genesis, 32 interop keys) fabricate them. Exact equality:

* for seeds 0 and 7 the sessions (update and committee) and the genesis
  validators root equal the reference's byte for byte;
* the port's LC engine (its device arm over the kernels' plain versions
  on the CPU) gives the reference engine's verdicts (its host loop on the
  native bls backend) on the sessions and their tampered copies (a flipped signature byte, a stale
  header): True for every fabricated session, False for every tampered
  one.
"""

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.light_client import engine as r_engine
from lighthouse_tpu.testing import StateHarness as RHarness
from lighthouse_tpu.testing import lc_workload as r_lcw
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch.light_client import engine as p_engine
from lighthouse_tpu_torch.testing import StateHarness as PHarness
from lighthouse_tpu_torch.testing import fabricate_lc_sessions, tamper_session
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

N_SESSIONS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harnesses():
    return (RHarness(r_minimal(altair_fork_epoch=0), 32),
            PHarness(p_minimal(altair_fork_epoch=0), 32))


def _bytes(sessions):
    return [(bytes(u.serialize()), bytes(c.serialize())) for u, c in sessions]


@pytest.mark.parametrize("seed", [0, 7])
def test_sessions_equal_reference_byte_for_byte(harnesses, seed):
    rh, ph = harnesses
    want, r_gvr = r_lcw.fabricate_lc_sessions(rh, N_SESSIONS, seed)
    got, p_gvr = fabricate_lc_sessions(ph, N_SESSIONS, seed)
    assert p_gvr == r_gvr
    assert _bytes(got) == _bytes(want)
    for mode in ("signature", "header"):
        assert _bytes([tamper_session(got[0], mode)]) == _bytes(
            [r_lcw.tamper_session(want[0], mode)])


def test_sessions_verify_on_the_port_engine_as_on_the_reference(harnesses):
    """The fabricated sessions in one batch; each tampered copy alone (a
    mixed batch would bisect, one plain-version batch a split)."""
    rh, ph = harnesses
    r_sessions, gvr = r_lcw.fabricate_lc_sessions(rh, N_SESSIONS, 7)
    p_sessions, _ = fabricate_lc_sessions(ph, N_SESSIONS, 7)
    modes = ("signature", "header")
    r_batches = [r_sessions] + [[r_lcw.tamper_session(r_sessions[1], m)] for m in modes]
    p_batches = [p_sessions] + [[tamper_session(p_sessions[1], m)] for m in modes]
    r_prev = (r_engine.get_lc_backend(), r_bls.get_backend())
    p_prev = (p_engine.get_lc_backend(), p_engine.get_lc_device())
    r_engine.set_lc_backend("host")
    r_bls.set_backend("native")
    p_engine.set_lc_backend("device", device="cpu")
    try:
        want = [r_engine.verify_update_batch(rh.spec, b, gvr) for b in r_batches]
        got = [p_engine.verify_update_batch(ph.spec, b, gvr) for b in p_batches]
    finally:
        r_engine.set_lc_backend(r_prev[0])
        r_bls.set_backend(r_prev[1])
        p_engine.set_lc_backend(p_prev[0], device=p_prev[1])
    assert want == [[True] * N_SESSIONS, [False], [False]]
    assert got == want
