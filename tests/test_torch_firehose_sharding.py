"""The port's sharded serving tier against the reference's: ``plan_shards``,
``ShardPlan`` and ``MeshVerifier`` (``firehose/sharding.py``), and the
chain's mesh seam.

Every ``MeshVerifier`` case of the reference's own suite
(``tests/test_firehose_sharding.py``) runs here once per package over the
same pure-Python stub backend and the same injected faults; the per-group
verdicts, the stub's dispatch record, every supervisor's snapshot and the
two mesh metrics' deltas must be equal. No device work: the mesh kernels
are pinned in ``tests/test_torch_mesh*.py``.
"""

import random
import threading
import time
import types

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu import resilience as r_res
from lighthouse_tpu.firehose import (
    FirehoseConfig as RFirehoseConfig,
    FirehoseEngine as RFirehoseEngine,
    MeshVerifier as RMeshVerifier,
    plan_shards as r_plan_shards,
)
from lighthouse_tpu.utils import metrics as r_metrics

from lighthouse_tpu_torch import resilience as p_res
from lighthouse_tpu_torch.firehose import (
    FirehoseConfig as PFirehoseConfig,
    FirehoseEngine as PFirehoseEngine,
    MeshShrunk,
    MeshVerifier as PMeshVerifier,
    ShardPlan,
    plan_shards as p_plan_shards,
)
from lighthouse_tpu_torch.utils import metrics as p_metrics

REF = types.SimpleNamespace(
    name="reference", MeshVerifier=RMeshVerifier, plan_shards=r_plan_shards, res=r_res,
    FirehoseEngine=RFirehoseEngine, FirehoseConfig=RFirehoseConfig, metrics=r_metrics,
)
PORT = types.SimpleNamespace(
    name="port", MeshVerifier=PMeshVerifier, plan_shards=p_plan_shards, res=p_res,
    FirehoseEngine=PFirehoseEngine, FirehoseConfig=PFirehoseConfig, metrics=p_metrics,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean():
    for pkg in (REF, PORT):
        pkg.res.injector.clear()
        pkg.res.reset_all()


@pytest.fixture(autouse=True)
def clean_fault_domains():
    _clean()
    yield
    _clean()


def force_probation_due(sup):
    """Make a QUARANTINED supervisor's probation due at once (no sleeping
    through the real cool-off)."""
    with sup._lock:
        if sup._quarantined_at is not None:
            sup._quarantined_at = time.monotonic() - 3600.0


# -- shard planner ------------------------------------------------------------------


def _seeded_groups(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [[(int(seed), g, j) for j in range(int(rng.choice([1, 3])))] for g in range(n)]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_shards_matches_reference(seed, n_shards):
    groups = _seeded_groups(seed, 3 + 7 * seed)
    for floor in (1, 4):
        want = r_plan_shards(groups, n_shards, cap_floor=floor)
        got = p_plan_shards(groups, n_shards, cap_floor=floor)
        assert isinstance(got, ShardPlan)
        assert (got.shard_items, got.group_shard, got.cap) == (
            want.shard_items, want.group_shard, want.cap)
        for g, s in zip(groups, got.group_shard):  # a group never straddles shards
            assert all(it in got.shard_items[s] for it in g)
    empty = p_plan_shards([], n_shards)
    assert empty.group_shard == [] and not any(empty.shard_items)


# -- MeshVerifier: the reference's cases on both packages ---------------------------


class _Stub:
    """Recording stub backend: per-shard verdicts from ``bad_shards`` (device
    ids), faults from ``raise_on``."""

    def __init__(self):
        self.dispatches = []
        self.singles = []
        self.oracles = []
        self.bad_shards = set()
        self.raise_on = set()

    def dispatch(self, shard_items, device_ids, staged=None, shard_cap=None):
        self.dispatches.append((tuple(device_ids), staged is not None))
        if set(device_ids) & self.raise_on:
            raise RuntimeError("injected transient dispatch fault")
        return [i not in self.bad_shards for i in device_ids]

    def single(self, items):
        self.singles.append(len(items))
        return True

    def oracle(self, items):
        self.oracles.append(len(items))
        return True


def _verifier(pkg, stub, n=8, **kw):
    return pkg.MeshVerifier(n, dispatch_fn=stub.dispatch, single_fn=stub.single,
                            oracle_fn=stub.oracle, **kw)


def _groups(n):
    return [[(i,)] for i in range(n)]


def case_happy(pkg, stub, out):
    mv = _verifier(pkg, stub)
    out["v"] = mv.verify_groups(_groups(10))
    assert out["v"] == [True] * 10
    return mv


def case_failed_shard(pkg, stub, out):
    stub.bad_shards = {2}
    mv = _verifier(pkg, stub)
    out["v"] = mv.verify_groups(_groups(8))
    assert out["v"] == [g != 2 for g in range(8)]
    return mv


def case_injected_shard_fault(pkg, stub, out):
    mv = _verifier(pkg, stub)
    pkg.res.injector.install("stage=mesh.shard3;mode=raise;kind=oom;every=1;times=2")
    out["v"] = mv.verify_groups(_groups(10))
    assert stub.dispatches[-1][0] == (4, 5, 6, 7)
    return mv


def case_quarantine_then_repromote(pkg, stub, out):
    mv = _verifier(pkg, stub)
    pkg.res.injector.install("stage=mesh.shard3;mode=raise;kind=oom;every=1;times=2")
    out["v"] = [mv.verify_groups(_groups(10)) for _ in range(2)]
    out["quarantined"] = mv.shard_sups[3].snapshot()["state"]
    out["healthy"] = mv.healthy_indices()
    for _ in range(10):
        force_probation_due(mv.mesh_sup)
        force_probation_due(mv.shard_sups[3])
        out["v"].append(mv.verify_groups(_groups(10)))
    assert out["quarantined"] == "QUARANTINED" and 3 not in out["healthy"]
    assert stub.dispatches[-1][0] == tuple(range(8))
    assert mv.shard_sups[3].snapshot()["state"] == "HEALTHY"
    return mv


def case_probe_attribution(pkg, stub, out):
    stub.raise_on = {0}

    def probe(device_id):
        if device_id in stub.raise_on:
            raise RuntimeError("device probe transient failure")

    mv = _verifier(pkg, stub, probe_fn=probe)
    out["v"] = mv.verify_groups(_groups(6))
    assert stub.dispatches[-1][0] == (4, 5, 6, 7)
    return mv


def case_unattributed_reaches_single(pkg, stub, out):
    stub.raise_on = set(range(8))
    mv = _verifier(pkg, stub)
    out["v"] = mv.verify_groups(_groups(6))
    assert stub.singles == [6]
    return mv


def case_corruption_jumps_to_oracle(pkg, stub, out):
    mv = _verifier(pkg, stub)
    pkg.res.injector.install("stage=mesh.shard1;mode=corrupt;at=1")
    out["v"] = mv.verify_groups(_groups(4))
    assert stub.oracles == [4] and stub.singles == []
    return mv


def case_all_rungs_fail_closed(pkg, stub, out):
    stub.raise_on = set(range(8))

    def bad_single(items):
        raise RuntimeError("single device down")

    mv = pkg.MeshVerifier(8, dispatch_fn=stub.dispatch, single_fn=bad_single, oracle_fn=None)
    with pytest.raises(pkg.res.SupervisedFault):
        mv.verify_groups([[(1,)], [(2,)]])
    out["v"] = "raised"
    return mv


def case_verify_items(pkg, stub, out):
    mv = _verifier(pkg, stub)
    out["v"] = [mv.verify_items([(1,), (2,), (3,)])]
    stub.bad_shards = {0}
    out["v"].append(mv.verify_items(_groups(8)))
    assert out["v"] == [True, False]
    return mv


def case_staged_and_restage(pkg, stub, out):
    staged_calls = []

    def stage(shard_items, device_ids, cap):
        staged_calls.append(tuple(device_ids))
        return {"cap": cap}

    mv = _verifier(pkg, stub, stage_fn=stage)
    groups = _groups(8)
    out["v"] = [mv.verify_groups(groups, staged=mv.stage(groups))]
    pkg.res.injector.install("stage=mesh.shard0;mode=raise;kind=oom;every=1;times=1")
    out["v"].append(mv.verify_groups(groups, staged=mv.stage(groups)))
    out["staged"] = staged_calls
    assert stub.dispatches[-1] == ((4, 5, 6, 7), False)
    return mv


def case_seeded_chaos(pkg, stub, out):
    """The reference's chaos scenario: a seeded lossy stream, a device that
    faults every 5th check and tampered payloads through the sharded engine."""
    rng = random.Random(0xC7A05)
    tampered = {i for i in range(200) if i % 17 == 0}

    def dispatch(shard_items, device_ids, staged=None, shard_cap=None):
        return [not any(it[0] in tampered for it in sh) for sh in shard_items]

    def verify_items(items):
        return not any(it[0] in tampered for it in items)

    mv = pkg.MeshVerifier(8, dispatch_fn=dispatch, single_fn=verify_items, oracle_fn=verify_items)
    pkg.res.injector.install("stage=mesh.shard5;mode=raise;kind=oom;every=5;times=4")
    engine = pkg.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps], verify_items_fn=verify_items,
        config=pkg.FirehoseConfig(max_batch=32, intake_capacity=64), synchronous=True,
        shard_planner=mv,
    )
    verdicts = {}
    for i in range(200):
        if rng.random() < 0.02:
            continue
        engine.submit(i, callback=lambda p, ok, m: verdicts.__setitem__(p, ok))
        if i % 32 == 31:
            engine.drain()
            force_probation_due(mv.mesh_sup)
            force_probation_due(mv.shard_sups[5])
    engine.drain()
    for j in range(24):
        force_probation_due(mv.mesh_sup)
        force_probation_due(mv.shard_sups[5])
        mv.verify_groups([[(1000 + j,)] for _ in range(8)])
    assert all(ok == (p not in tampered) for p, ok in verdicts.items())
    assert mv.shard_sups[5].snapshot()["state"] == "HEALTHY"
    out["v"] = sorted(verdicts.items())
    out["stats"] = engine.stats().as_dict()
    for k in ("p50_latency_s", "p99_latency_s", "p50_e2e_s", "p99_e2e_s"):
        out["stats"].pop(k)
    return mv


CASES = {f.__name__[5:]: f for f in (
    case_happy, case_failed_shard, case_injected_shard_fault, case_quarantine_then_repromote,
    case_probe_attribution, case_unattributed_reaches_single, case_corruption_jumps_to_oracle,
    case_all_rungs_fail_closed, case_verify_items, case_staged_and_restage, case_seeded_chaos,
)}


def _metric(m) -> dict:
    return {k: v for k, _, v in m.collect()}


def _run(pkg, case) -> dict:
    _clean()
    before = {k: _metric(getattr(pkg.metrics, k)) for k in ("MESH_SHARD_VERDICTS",)}
    stub = _Stub()
    out: dict = {}
    mv = CASES[case](pkg, stub, out)
    after = _metric(pkg.metrics.MESH_SHARD_VERDICTS)
    out["shard_verdicts"] = {
        k: v - before["MESH_SHARD_VERDICTS"].get(k, 0.0) for k, v in after.items()
        if v != before["MESH_SHARD_VERDICTS"].get(k, 0.0)
    }
    out["active"] = _metric(pkg.metrics.MESH_ACTIVE_DEVICES).get(("bls_mesh",))
    out["dispatches"], out["singles"], out["oracles"] = stub.dispatches, stub.singles, stub.oracles
    out["snapshot"] = mv.snapshot()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_verifier_matches_reference(case):
    assert _run(PORT, case) == _run(REF, case)


def test_mesh_shrunk_is_the_ladder_signal():
    assert issubclass(MeshShrunk, RuntimeError)
    mv = PMeshVerifier(4, dispatch_fn=lambda *a, **k: [True] * 4)
    with pytest.raises(MeshShrunk):
        mv._mesh_rung(_groups(2), 4, {0}, None)()


# -- the engine's shard path ---------------------------------------------------------


def _engine_shard_run(pkg) -> tuple:
    bad = {3, 6}
    bisect_calls = []

    def dispatch(shard_items, device_ids, staged=None, shard_cap=None):
        return [not any(it[0] in bad for it in sh) for sh in shard_items]

    def verify_items(items):
        bisect_calls.append([it[0] for it in items])
        return not any(it[0] in bad for it in items)

    mv = pkg.MeshVerifier(8, dispatch_fn=dispatch, single_fn=None, oracle_fn=None)
    engine = pkg.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], f"m{p}") for p in ps], verify_items_fn=verify_items,
        config=pkg.FirehoseConfig(max_batch=16), synchronous=True, shard_planner=mv,
    )
    verdicts = {}
    for i in range(8):
        engine.submit(i, callback=lambda p, ok, m: verdicts.__setitem__(p, ok))
    engine.drain()
    st = engine.stats()
    return verdicts, bisect_calls, (st.verified, st.rejected, st.errored)


def test_engine_bisects_only_failed_shards_as_the_reference():
    got = _engine_shard_run(PORT)
    assert got == _engine_shard_run(REF)
    assert got[0] == {i: i not in {3, 6} for i in range(8)}
    assert {p for call in got[1] for p in call} <= {3, 6}


def test_threaded_engine_stages_on_the_prep_thread():
    stage_threads, dispatch_staged = [], []
    done = threading.Event()

    def stage(shard_items, device_ids, cap):
        stage_threads.append(threading.current_thread().name)
        return {"cap": cap}

    def dispatch(shard_items, device_ids, staged=None, shard_cap=None):
        dispatch_staged.append(staged is not None)
        if len(dispatch_staged) >= 2:
            done.set()
        return [True] * len(device_ids)

    mv = PMeshVerifier(4, dispatch_fn=dispatch, stage_fn=stage, single_fn=None, oracle_fn=None)
    engine = PFirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps], verify_items_fn=lambda items: True,
        config=PFirehoseConfig(max_batch=4, deadline_s=0.001), shard_planner=mv,
    )
    for i in range(8):
        engine.submit(i)
    done.wait(5.0)
    engine.stop(drain_timeout=10.0)
    assert engine.stats().verified == 8
    assert all(t.startswith("firehose-prep") for t in stage_threads)
    assert dispatch_staged and all(dispatch_staged)


# -- the chain's mesh seam ------------------------------------------------------------


@pytest.fixture()
def chain():
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state
    from lighthouse_tpu_torch.types.spec import minimal_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    spec = minimal_spec()
    state = interop_genesis_state(spec, 16)
    prev = (bls.get_backend(), bls.get_device(), bls.get_mesh())
    bls.set_backend("device", device="cpu", mesh_devices=[])
    yield lambda: BeaconChain(spec, state.copy(), slot_clock=ManualSlotClock(0))
    bls.set_backend(prev[0], device=prev[1], mesh_devices=prev[2] or [])


def test_mesh_off_means_no_planner(chain, monkeypatch):
    from lighthouse_tpu_torch import bls

    monkeypatch.setenv("LIGHTHOUSE_MESH_DEVICES", "8")  # read by nothing in the port
    bls.set_backend("device", device="cpu")
    assert bls.get_mesh() is None
    c = chain()
    assert c._mesh_planner() is None
    bls.set_backend("device", device="cpu", mesh_devices=["cpu"])  # one device: off
    assert c._mesh_planner() is None


def test_reselection_keeps_the_mesh_and_the_chain_follows_it(chain):
    """A backend re-selection that names no mesh (as the conformance
    runner's select-and-restore does) keeps it; the chain's planner follows
    every change of the backend or the mesh, and ``[]`` turns the mesh off."""
    from lighthouse_tpu_torch import bls

    cpu = torch.device("cpu")
    bls.set_backend("device", device="cpu", mesh_devices=["cpu"] * 2)
    c = chain()
    assert c._mesh_planner().n_devices == 2
    bls.set_backend("oracle")
    assert bls.get_mesh() == [cpu] * 2 and c._mesh_planner() is None
    bls.set_backend("device", device="cpu")
    assert bls.get_mesh() == [cpu] * 2 and c._mesh_planner().n_devices == 2
    bls.set_backend("device", device="cpu", mesh_devices=["cpu"] * 4)
    assert c._mesh_planner().n_devices == 4
    bls.set_backend("device", device="cpu", mesh_devices=[])
    assert bls.get_mesh() is None and c._mesh_planner() is None


@pytest.mark.parametrize("backend", ["oracle", "native"])
def test_other_backends_never_build_a_mesh(chain, backend):
    from lighthouse_tpu_torch import bls

    bls.set_backend(backend, mesh_devices=["cpu"] * 4)
    assert chain()._mesh_planner() is None


def test_cpu_mesh_routes_batch_verify_through_the_verifier(chain):
    from lighthouse_tpu_torch import bls

    bls.set_backend("device", device="cpu", mesh_devices=["cpu"] * 2)
    c = chain()
    mv = c._mesh_planner()
    assert isinstance(mv, PMeshVerifier) and mv.n_devices == 2
    assert [r for r, _ in mv._rungs(_groups(1), None)] == ["mesh2", "device_single", "cpu_oracle"]
    dispatches = []

    def stub_dispatch(shard_items, device_ids, staged=None, shard_cap=None):
        dispatches.append(tuple(device_ids))
        return [True] * len(device_ids)

    mv.dispatch_fn = stub_dispatch
    items = [([0], b"\x22" * 32, b"\x99" * 96), ([1], b"\x33" * 32, b"\x88" * 96)]
    assert c._batch_verify_items(items) is True
    assert dispatches == [(0, 1)]
    assert c.create_firehose(synchronous=True).shard_planner is mv


def test_card_mesh_planner_has_no_oracle_rung(chain):
    """Built (not run) for cards, which needs no card: the ladder ends at the
    single device and fails closed."""
    from lighthouse_tpu_torch import bls

    bls.set_backend("device", device="cpu", mesh_devices=["cuda:0"] * 4)
    mv = chain()._mesh_planner()
    assert mv.n_devices == 4 and mv.oracle_fn is None
    assert [r for r, _ in mv._rungs(_groups(1), None)] == ["mesh4", "mesh2", "device_single"]


def test_client_places_the_mesh_from_its_config():
    """``ClientConfig.mesh_devices`` (``bn --mesh-devices``) reaches the bls
    seam; without it the node's mesh is off."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.bls.mesh import parse_mesh_devices
    from lighthouse_tpu_torch.client import ClientConfig, _place_backends
    from lighthouse_tpu_torch.kzg import engine as kzg_engine

    prev = (bls.get_backend(), bls.get_device(), bls.get_mesh(), kzg_engine.get_kzg_backend(),
            kzg_engine.get_kzg_device())
    cpu = torch.device("cpu")
    try:
        cfg = ClientConfig(device="cpu", mesh_devices=parse_mesh_devices("cpu,cpu"))
        _place_backends(cpu, cfg.mesh_devices)
        assert bls.get_mesh() == [cpu, cpu] and kzg_engine.get_kzg_device() == cpu
        assert ClientConfig().mesh_devices is None
        _place_backends(cpu)
        assert bls.get_mesh() is None
    finally:
        bls.set_backend(prev[0], device=prev[1], mesh_devices=prev[2] or [])
        kzg_engine.set_kzg_backend(prev[3], device=prev[4])
