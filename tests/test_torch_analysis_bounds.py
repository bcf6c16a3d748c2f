"""The port's analysis passes 1, 3 and 4 against the reference's.

``lighthouse_tpu_torch.analysis.bounds`` certifies the limb stack on the
meta device; the reference certifies its Pallas regime under
``jax.eval_shape`` (interpret mode). Over the same graph names the two
certificates prove the same values for every ``pallas_*`` obligation kind
both record, against the same limits. Beyond the reference: the caches
(schedules, prepared plans, chain programs, the certified builders) replay
what their derivations proved, so a second certificate in one process
records the same obligations as the first; and the whole registry at both
batch regimes certifies on meta within 15 s. The seeded mutations (a lazy
interior widened by one squaring, an overflowing lincomb, a shared-memory
limit below a schedule's bytes) fail the certificate.

The build sentinel (pass 3): a CPU firehose loop over the plan kernel's
wrapper and successive epoch sweeps build nothing once warm, and a step
that derives a new plan signature is seen. The supervisor probe (pass 4)
passes on the CPU, and a watchdog worker runs its call on the caller's CUDA
device.
"""

import collections
import time

import pytest
import torch

import lighthouse_tpu  # noqa: F401  (jax x64)
from lighthouse_tpu.analysis import bounds as r_bounds

from lighthouse_tpu_torch.analysis import bounds, recompile, supervised
from lighthouse_tpu_torch.analysis.bounds import Spec
from lighthouse_tpu_torch.ops.bls import fq, fused_mul, plans, tower


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARITY_GRAPHS = ["fq.mont_mul", "fq.inv", "tower.fq12_mul", "tower.fq2_sqrt",
                 "curve.point_dbl", "pallas."]


def _keys(cert) -> collections.Counter:
    return collections.Counter({
        (r["graph"], r["kind"], r["site"], r.get("proven"), r.get("limit")): r["count"]
        for r in cert["obligations"]
    })


def test_caches_hide_nothing():
    """A fresh plan signature proves its obligations on the first run and
    replays them from the cache on the second; a certified builder's hit
    replays its miss; a second certificate equals the first."""
    p = plans.Plan(2, 2)
    x, y = plans.vbasis(2), plans.vbasis(2)
    p.out_rows = p.mul2(x, y)
    e2 = Spec((4, 2, 25))

    def fresh(a, b):
        return plans.execute(p, a, b, name="fresh_signature")

    misses = fq.builds["plan_miss"]
    first = bounds.certify_callable(fresh, (e2, e2))
    assert fq.builds["plan_miss"] == misses + 1
    second = bounds.certify_callable(fresh, (e2, e2))
    assert fq.builds["plan_miss"] == misses + 1
    assert first == second and len(first) > 10
    assert all(r["ok"] for r in first)

    calls = []

    @fq.certified_cache
    def builder(k):
        calls.append(k)
        fq._cert("test_builder", k, 10, note="analysis test")
        return k

    got = [bounds.certify_callable(lambda a: builder(3), (Spec((1, 25)),)) for _ in range(2)]
    assert calls == [3] and got[0] == got[1]
    assert [r["kind"] for r in got[0]] == ["test_builder"]

    graphs = ["fq.", "tower.fq2_sqrt", "pallas.", "pairing.final_exponentiation"]
    c1 = bounds.certify(batches=(1,), graphs=graphs)
    c2 = bounds.certify(batches=(1,), graphs=graphs)
    assert c1["ok"] and c2["ok"]
    assert c1["n_obligations"] == c2["n_obligations"] > 0
    assert _keys(c1) == _keys(c2)


def test_pallas_proven_values_equal_the_reference():
    ref = r_bounds.certify(backends=("pallas",), batches=(1,), graphs=PARITY_GRAPHS)
    port = bounds.certify(batches=(1,), graphs=PARITY_GRAPHS)
    assert ref["ok"] and port["ok"], [r for r in port["obligations"] if not r["ok"]][:3]

    def table(cert, field):
        out = collections.defaultdict(list)
        for r in cert["obligations"]:
            if r["kind"].startswith("pallas_"):
                out[(r["graph"].split("/", 1)[1], r["kind"])].append(r[field])
        return {k: sorted(v) for k, v in out.items()}

    rp, pp = table(ref, "proven_bits"), table(port, "proven_bits")
    rl, pl = table(ref, "limit_bits"), table(port, "limit_bits")
    shared = {k for _, k in rp} & {k for _, k in pp}
    assert {"pallas_conv_digit_f32_exact", "pallas_fold_f32_exact", "pallas_lincomb_f32_exact",
            "pallas_reduce_value", "pallas_reduce_limb", "pallas_out_bound_top_sound"} <= shared
    ref_graphs = {g for g, k in rp if k in shared}
    assert ref_graphs == {g for g, k in pp if k in shared}
    assert len(ref_graphs) >= 12
    for key in set(rp) | set(pp):
        if key[1] not in shared:
            continue
        assert rp.get(key) == pp.get(key), key
        # the limits are the reference's (f32 exactness, the declared
        # bounds), except a cap of 2^64 that the port proves against 2^63
        assert [b if b != 64.0 else 63.0 for b in rl.get(key, [])] == pl.get(key), key


def test_whole_registry_certifies_on_meta_within_15s():
    t0 = time.perf_counter()
    cert = bounds.certify(batches=(1, 32))
    elapsed = time.perf_counter() - t0
    bad = [r for r in cert["obligations"] if not r["ok"]]
    assert cert["ok"] and not bad, bad[:3]
    graphs = {r["graph"] for r in cert["obligations"]}
    names = {n for n, _, _ in bounds.graph_registry(1)}
    for regime in ("cuda@b1", "cuda@b32"):
        covered = {g.split("/", 1)[1] for g in graphs if g.startswith(regime)}
        # every graph records obligations but the Fr bit split (no product,
        # no accumulation: nothing to bound)
        assert names - covered <= {"kzg.fr_bits"}, names - covered
    kinds = {r["kind"] for r in cert["obligations"]}
    assert {"cuda_smem_bytes", "cuda_plane_width", "lincomb_value_budget",
            "pallas_conv_digit_f32_exact", "reduce_value", "slasher_window_width",
            "epoch_validator_index_domain", "epoch_churn_cumsum_headroom",
            "kzg.fr_dot.acc", "carry_norm_value"} <= kinds
    assert cert["smem_limit"] == fused_mul.SMEM_LIMIT
    assert elapsed < 15.0, elapsed


def test_fast_meta_shapes_equal_the_meta_kernels():
    """The abstract run computes the pointwise ops' outputs itself; on the
    graphs' own operands they equal the meta kernels' shapes and dtypes."""
    a = torch.zeros((3, 1, 25), dtype=torch.int64, device="meta")
    b = torch.zeros((4, 25), dtype=torch.int64, device="meta")
    m = torch.zeros((3, 4), dtype=torch.bool, device="meta")
    u8 = torch.zeros((4, 25), dtype=torch.uint8, device="meta")
    aten = torch.ops.aten
    cases = [
        (aten.add.Tensor, (a, b)), (aten.bitwise_and.Scalar, (a, 0xFF)),
        (aten.__rshift__.Scalar, (b, 8)), (aten.mul.Tensor, (u8, b)),
        (aten.gt.Scalar, (a, 3)), (aten.where.self, (m[..., None], a, b)),
        (aten.cat.default, ([b, b[:1]], 0)), (aten.zeros_like.default, (a,)),
        (aten.bitwise_or.Tensor, (m, m)), (aten.neg.default, (b,)),
        (aten.sub.Scalar, (u8, 1)), (aten.eq.Tensor, (a, b)),
    ]
    for op, args in cases:
        fast = bounds._meta_result(op, args, {})
        slow = op(*args)
        assert fast is not None, op
        assert (fast.shape, fast.dtype) == (slow.shape, slow.dtype), op


def test_seeded_mutation_widened_interior_fails(monkeypatch):
    """A lazy interior widened by one squaring (the declared chain bound
    becomes the square's) fails: the limb budget blows past 2^22."""
    widened = plans._Bound(
        plans.CHAIN_BOUND.value_p ** 2, plans.CHAIN_BOUND.limb ** 2, plans.CHAIN_BOUND.top,
    )
    monkeypatch.setattr(plans, "CHAIN_BOUND", widened)
    rows = bounds.certify_callable(tower.fq2_sqr_lazy, (Spec((4, 2, 25)),))
    assert any(not r["ok"] for r in rows)
    assert any(r["kind"] in ("lincomb_limb_budget", "unproven_bound") and not r["ok"]
               for r in rows)


def test_seeded_mutation_overflowing_lincomb_fails():
    p = plans.Plan(2, 2)
    x, y = plans.vbasis(2), plans.vbasis(2)
    lane = p.lane(x[0].scale(1 << 21), y[0])
    p.out_rows = [lane, lane]
    e2 = Spec((4, 2, 25))
    rows = bounds.certify_callable(
        lambda a, b: plans.execute(p, a, b, name="bad_lincomb"), (e2, e2))
    assert any(not r["ok"] and r["kind"] in ("lincomb_limb_budget", "unproven_bound")
               for r in rows)


def test_seeded_mutation_smem_limit_below_a_schedule_fails(monkeypatch):
    sched = fused_mul.mul_schedule(False)
    monkeypatch.setattr(fused_mul, "SMEM_LIMIT", sched.smem_bytes(1) - 1)
    e1 = Spec((4, 25))
    rows = bounds.certify_callable(fq.mont_mul, (e1, e1))
    assert any(not r["ok"] for r in rows)
    assert any(r["kind"] in ("cuda_smem_bytes", "unproven_bound") and not r["ok"]
               for r in rows)


# --------------------------------------------------------------------------------------
# Pass 3 — the build sentinel
# --------------------------------------------------------------------------------------


def test_firehose_loop_builds_nothing_once_warm():
    """The firehose's prep, batching and bucketed device stage (the plan
    kernel's wrapper, on the CPU its plain version, over power-of-two
    buckets) builds nothing after warm-up."""
    from lighthouse_tpu_torch.bls import backend
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine

    def verify(items):
        n_pad = backend.bucket(len(items))
        x = torch.ones((n_pad, fq.NLIMBS), dtype=torch.int64)
        return bool(fq.mont_mul(x, x)[0, 0] >= 0)

    engine = FirehoseEngine(
        prepare_fn=lambda ps: [([p], None) for p in ps], verify_items_fn=verify,
        config=FirehoseConfig(max_batch=8), synchronous=True,
    )

    def step():
        for i in range(8):
            assert engine.submit(i)
        engine.drain()

    assert recompile.steady_state_builds(step, warmup=2, steps=4) == []


def test_epoch_sweeps_build_nothing_once_warm():
    from lighthouse_tpu_torch import epoch_engine
    from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state
    from lighthouse_tpu_torch.types.spec import minimal_spec

    spec = minimal_spec(altair_fork_epoch=0)
    state = interop_genesis_state(spec, 64)
    slots = spec.preset.SLOTS_PER_EPOCH
    state.slot = 5 * slots - 1

    def step():
        assert epoch_engine.maybe_process_epoch_on_device(spec, state, device="cpu")
        state.slot += slots

    prev = (epoch_engine.get_backend(), epoch_engine.get_device())
    epoch_engine.set_backend("device", device="cpu")
    try:
        assert recompile.steady_state_builds(step, warmup=2, steps=3) == []
    finally:
        epoch_engine.set_backend(prev[0], device=prev[1])


def test_a_step_deriving_a_new_schedule_is_flagged():
    x = torch.ones((2, 2, fq.NLIMBS), dtype=torch.int64, device="meta")

    def leaky_step():
        p = plans.Plan(2, 2)  # a new plan object every step: a new signature
        p.out_rows = p.mul2(plans.vbasis(2), plans.vbasis(2))
        plans.execute(p, x, x, name="leaky")

    names = recompile.steady_state_builds(leaky_step, warmup=1, steps=3)
    assert names.count("plan_miss") == 3
    assert names.count("schedule") == 3
    assert recompile.recompile_probe("cpu")["ok"]


# --------------------------------------------------------------------------------------
# Pass 4 — the supervisor probe
# --------------------------------------------------------------------------------------


def test_supervisor_probe_passes_on_cpu():
    rep = supervised.supervisor_probe("cpu")
    assert rep["ok"], rep
    assert rep["transparent"] and rep["steady_state_builds"] == []
    assert rep["lint_findings"] == []


def test_watchdog_runs_the_call_on_the_callers_cuda_device(monkeypatch):
    """The current CUDA device is per thread: a supervised call's watchdog
    worker takes the caller's (here a stand-in torch.cuda on device 1)."""
    from lighthouse_tpu_torch.resilience.supervisor import BackendSupervisor, SupervisorConfig

    state = {"current": 1}
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])

    def set_device(d):
        calls.append(d)

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    sup = BackendSupervisor("analysis.device_carry", SupervisorConfig(deadline_s=5.0))
    assert sup.run_ladder("probe", (("device_full", lambda: 7),)) == 7
    assert calls == [1]
