"""The epoch engine's and the slasher's row-block arms on a CPU mesh of four.

Epoch: the reference suite's randomized states (every edge population;
electra's churn-straddling deposits and chained consolidations) at 301
validators — not a multiple of four, so the last real rows and the padding
fall in different blocks — cross as SSZ bytes; the port's sweep over
``[cpu] * 4`` row blocks gives the reference's unsharded
``process_epoch_on_device`` post-state field for field (SSZ bytes) and by
``tree_root``. A second boundary after journaled registry mutations runs
through the blocked mirror's delta sync.

Slasher: a span store whose planes are split into four validator row
blocks gives the unsharded store's planes and per-pair outputs after ticks
with surround and double votes.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (enables x64)
import test_epoch_engine as ref_states  # the reference suite's state constructors
from lighthouse_tpu import epoch_engine as R
from lighthouse_tpu.epoch_engine.engine import process_epoch_on_device as r_process_on_device

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as P
from lighthouse_tpu_torch.epoch_engine import engine as p_engine
from lighthouse_tpu_torch.state_transition import common as p_common
from lighthouse_tpu_torch.state_transition import electra as p_electra
from lighthouse_tpu_torch.types import spec as p_spec

CPU4 = [torch.device("cpu")] * 4
N_VALIDATORS = 301


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def backends():
    saved = (R.get_backend(), P.get_backend(), P.get_device(), P.get_mesh())
    yield
    R.set_backend(saved[0])
    P.set_backend(saved[1], device=saved[2], mesh_devices=saved[3] or [])


def _pspec(fork: str):
    forks = {"phase0": {}, "altair": {"altair_fork_epoch": 0},
             "electra": {k: 0 for k in ("altair_fork_epoch", "bellatrix_fork_epoch",
                                        "capella_fork_epoch", "deneb_fork_epoch",
                                        "electra_fork_epoch")}}
    return p_spec.minimal_spec(**forks[fork])


def _state(fork: str, seed: int, monkeypatch):
    monkeypatch.setattr(ref_states, "N_VALIDATORS", N_VALIDATORS)
    rspec = ref_states._spec(fork)
    if fork == "electra":
        state = ref_states._electra_state(rspec, seed)
    else:
        state = ref_states._random_state(rspec, fork, seed)
    assert len(state.validators) % 4 != 0
    return rspec, state


@pytest.mark.parametrize("fork,seed", [("phase0", 5), ("altair", 6), ("electra", 7)])
def test_blocked_epoch_boundary_equals_the_reference(fork, seed, monkeypatch):
    rspec, state = _state(fork, seed, monkeypatch)
    ref = state.copy()
    R.set_backend("device")
    assert r_process_on_device(rspec, ref)
    port = convert.state_from_ssz(_pspec(fork), state.fork_name, state.serialize())
    P.set_backend("device", device="cpu", mesh_devices=["cpu"] * 4)
    assert P.maybe_process_epoch_on_device(_pspec(fork), port)
    m = p_engine.mirror_of(port)
    assert m.mesh == CPU4 and [t.shape[0] for t in m.cols["effective"]] == [128] * 4
    assert port.serialize() == ref.serialize()
    assert port.tree_root() == ref.tree_root()


def test_blocked_mirror_delta_sync_across_epochs(monkeypatch):
    """Journaled mutations between boundaries (a compounding switch, an
    exit, in different blocks) reach the blocked mirror as deltas; the
    second boundary equals the single-device sweep's."""
    rspec, state = _state("electra", 37, monkeypatch)
    pspec = _pspec("electra")
    runs = []
    for mesh in ([], ["cpu"] * 4):
        s = convert.state_from_ssz(pspec, state.fork_name, state.serialize())
        P.set_backend("device", device="cpu", mesh_devices=mesh)
        for _ in range(2):
            assert P.maybe_process_epoch_on_device(pspec, s)
            s.slot += rspec.preset.SLOTS_PER_EPOCH
            p_electra.switch_to_compounding_validator(pspec, s, 8)
            p_common.initiate_validator_exit(pspec, s, 200)
        stats = P.engine_stats(s)
        assert stats["full_syncs"] == 1 and stats["delta_syncs"] == 1, stats
        runs.append(s)
    assert runs[1].serialize() == runs[0].serialize()


# -- the slasher ----------------------------------------------------------------------


def _ticks(seed: int):
    """Five ticks of random votes over 600 validators (n_pad 1024: four row
    blocks of 256), with a surround pair planted on validator 5, a double
    vote on 517 and a vote of validator 700 in the last block."""
    rng = np.random.default_rng(seed)
    out = []
    for k, cur in enumerate(range(10, 15)):
        n = 300
        v = rng.integers(0, 600, n)
        t = cur - rng.integers(0, 2, n)
        s = t - rng.integers(1, 4, n)
        vh = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        if k == 1:
            v, s, t, vh = (np.append(a, x) for a, x in zip((v, s, t, vh), (5, 2, 10, 7)))
        if k == 3:
            v, s, t, vh = (np.append(a, x) for a, x in zip((v, s, t, vh), (5, 3, 9, 8)))
            v, s, t, vh = (np.append(a, x) for a, x in zip((v, s, t, vh), ([517] * 2, [9] * 2,
                                                                            [12] * 2, [11, 12])))
        if k == 4:
            v, s, t, vh = (np.append(a, x) for a, x in zip((v, s, t, vh), (700, 1, 14, 9)))
        out.append((v.astype(np.int64), s.astype(np.int64), t.astype(np.int64),
                    vh.astype(np.uint32), cur))
    return out


def test_blocked_span_planes_equal_unsharded():
    from lighthouse_tpu_torch.slasher.engine import SpanStore

    one = SpanStore(64, use_device=True, device="cpu")
    four = SpanStore(64, use_device=True, mesh_devices=["cpu"] * 4)
    assert four.mesh == CPU4 and four.stats()["mesh"] == ["cpu"] * 4
    flags = {"min": 0, "max": 0, "dbl": 0}
    for v, s, t, vh, cur in _ticks(11):
        a = one.apply(v, s, t, vh, cur)
        b = four.apply(v, s, t, vh, cur)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in flags:
            flags[k] += int(b[f"{k}_flag"].sum())
        assert isinstance(four.dev, list) and len(four.dev) == 4
    assert four.n_pad == 1024 and four.mode == "device"
    assert flags["min"] >= 1 and flags["max"] >= 1 and flags["dbl"] >= 1
    for x, y in zip(one.planes(), four.planes()):
        np.testing.assert_array_equal(x, y)
    four._checkpoint()  # the host checkpoint joins the blocks
    for x, y in zip(one.planes(), four.host):
        np.testing.assert_array_equal(x, y)
