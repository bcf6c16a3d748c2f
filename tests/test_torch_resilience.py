"""The port's fault-domain layer against the reference's, scenario by scenario.

``lighthouse_tpu_torch.resilience`` (faults, inject, supervisor) and the
firehose under injected device faults are the port's copies of
``lighthouse_tpu.resilience``. The scenarios of ``tests/test_resilience.py``
(TestClassifier, TestWatchdog, TestInjector, TestSupervisor,
TestFirehoseResilience) run here against BOTH packages, each with the
reference test's own assertions, and each returns a trace: the results and
rung sequence, the health state after every call, the supervisor snapshot,
the classified-fault ring and the deltas of the ``resilience_*`` counters
of its domain. For every scenario whose trace the clock cannot change the
two packages' traces must be equal.

Wall-clock margins are at least 0.5 s (the suite runs with 6 workers): the
hang scenarios sleep 1.0 s past a 0.05 s watchdog where the reference test
sleeps 0.4 s, and the probation scenario uses a 0.6 s probation where the
reference uses 0.05 s.

Beyond the reference: the port classifies CUDA's sticky errors, the
kernels' launch failures and ``torch.cuda.OutOfMemoryError``'s text
(``test_cuda_errors_are_classified``), and a sticky error with no CPU rung
fails the batch closed (``test_sticky_cuda_error_fails_closed``).
"""

import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import firehose as r_fh, resilience as r_res
from lighthouse_tpu.resilience import faults as r_faults
from lighthouse_tpu.utils import metrics as r_metrics

from lighthouse_tpu_torch import firehose as p_fh, resilience as p_res
from lighthouse_tpu_torch.resilience import faults as p_faults
from lighthouse_tpu_torch.utils import metrics as p_metrics

PKGS = {
    "ref": SimpleNamespace(res=r_res, faults=r_faults, fh=r_fh, metrics=r_metrics),
    "port": SimpleNamespace(res=p_res, faults=p_faults, fh=p_fh, metrics=p_metrics),
}
SEED = "11"  # LIGHTHOUSE_RESILIENCE_SEED for both packages
_RES_METRICS = (
    "RESILIENCE_FAULTS", "RESILIENCE_HEALTH", "RESILIENCE_DEMOTIONS",
    "RESILIENCE_PROMOTIONS", "RESILIENCE_RETRIES", "RESILIENCE_FALLBACK_CALLS",
    "RESILIENCE_WATCHDOG_TIMEOUTS",
)


def _counters(pkg) -> dict:
    out = {}
    for name in _RES_METRICS:
        m = getattr(pkg.metrics, name)
        with m._lock:
            out.update({(name, key): v for key, v in m._values.items()})
    return out


def _deltas(before: dict, after: dict, domains) -> dict:
    return {
        k: v - before.get(k, 0.0)
        for k, v in after.items()
        if any(d in k[1] for d in domains) and v != before.get(k, 0.0)
    }


def _ring(pkg) -> list:
    return [(r["stage"], r["kind"], r["domain"], r["rung"], r["attempt"])
            for r in pkg.res.recent_faults(512)]


def _fast_config(pkg, **kw):
    base = dict(
        deadline_s=5.0, max_retries=2, backoff_base_s=0.001,
        backoff_max_s=0.005, promote_after=2, probe_every=2,
        probation_s=0.05,
    )
    base.update(kw)
    return pkg.res.SupervisorConfig(**base)


class _Trace:
    """What a scenario records beside its own assertions."""

    def __init__(self, pkg, domains):
        self.pkg = pkg
        self.domains = domains
        self.before = _counters(pkg)
        self.steps = []

    def step(self, sup, result):
        self.steps.append((result, sup.state.name))

    def done(self, **extra) -> dict:
        return dict(
            steps=self.steps, ring=_ring(self.pkg),
            counters=_deltas(self.before, _counters(self.pkg), self.domains),
            **extra,
        )


# -- taxonomy / classifier ---------------------------------------------------------


def sc_type_first_classification(pkg):
    FK, classify = pkg.res.FaultKind, pkg.res.classify
    got = [
        classify(pkg.res.WatchdogTimeout("s", 1.0)), classify(TimeoutError("whatever")),
        classify(MemoryError()), classify(AssertionError("limb bound")),
        classify(FloatingPointError("overflow")),
    ]
    assert got == [FK.HANG, FK.HANG, FK.OOM, FK.CORRUPTION, FK.CORRUPTION]
    return [k.value for k in got]


def sc_marker_classification(pkg):
    class XlaRuntimeError(Exception):
        pass

    FK, classify = pkg.res.FaultKind, pkg.res.classify
    got = [
        classify(XlaRuntimeError("RESOURCE_EXHAUSTED: out of memory while trying "
                                 "to allocate 2.1G")),
        classify(XlaRuntimeError("UNAVAILABLE: connection reset by peer")),
        classify(XlaRuntimeError("INVALID_ARGUMENT: limb bound assert tripped")),
        classify(ValueError("totally novel")),
    ]
    assert got == [FK.OOM, FK.TRANSIENT, FK.CORRUPTION, FK.TRANSIENT]
    return [k.value for k in got]


def sc_subprocess_note_classification(pkg):
    FK, ct = pkg.res.FaultKind, pkg.res.classify_text
    got = [
        ct("probe hung (> 120s)"), ct("shape (16x64) exceeded 1800s"),
        ct("probe exited rc=1: RESOURCE_EXHAUSTED"),
        ct("RESOURCE_EXHAUSTED: memory limit exceeded while allocating"),
    ]
    assert got == [FK.HANG, FK.HANG, FK.OOM, FK.OOM]
    return [k.value for k in got]


def sc_injected_fault_carries_kind(pkg):
    e = pkg.res.InjectedFault(pkg.res.FaultKind.OOM, "stage", 3)
    assert pkg.res.classify(e) == pkg.res.FaultKind.OOM
    return str(e)


def sc_record_ring_and_metrics(pkg):
    tr = _Trace(pkg, ["t"])
    pkg.faults.record_fault("t.stage", MemoryError(), domain="t")
    recent = pkg.res.recent_faults(4)
    assert recent and recent[-1]["kind"] == "oom"
    assert "resilience_faults_total" in pkg.metrics.REGISTRY.render()
    return tr.done()


# -- watchdog ----------------------------------------------------------------------


def sc_watchdog_passthrough(pkg):
    assert pkg.res.run_with_deadline("t", lambda: 41 + 1, 5.0) == 42
    with pytest.raises(KeyError):
        pkg.res.run_with_deadline("t", lambda: {}["missing"], 5.0)
    return 42


def sc_watchdog_hang_detection(pkg):
    t0 = time.monotonic()
    with pytest.raises(pkg.res.WatchdogTimeout):
        pkg.res.run_with_deadline("t.hang", lambda: time.sleep(2.0), 0.05)
    assert time.monotonic() - t0 < 1.0  # caller reclaimed promptly
    return "hang"


# -- deterministic injector --------------------------------------------------------


def sc_injector_every_and_times(pkg):
    inj = pkg.res.injector
    inj.install("stage=u.s;mode=raise;kind=oom;every=3;times=2")
    fired = []
    for _ in range(12):
        try:
            inj.before_call("u.s")
            fired.append(False)
        except pkg.res.InjectedFault as e:
            assert pkg.res.classify(e) == pkg.res.FaultKind.OOM
            fired.append(True)
    assert fired == [False, False, True] * 2 + [False] * 6
    return dict(fired=fired, plans=inj.plans())


def sc_injector_at_nth_call_only(pkg):
    inj = pkg.res.injector
    inj.install("stage=u.n;at=2")
    outcomes = []
    for _ in range(4):
        try:
            inj.before_call("u.n")
            outcomes.append("ok")
        except pkg.res.InjectedFault:
            outcomes.append("boom")
    assert outcomes == ["ok", "boom", "ok", "ok"]
    return outcomes


def sc_injector_wildcard_and_rung_targeting(pkg):
    inj = pkg.res.injector
    inj.install("stage=u.lad/cpu_fallback;at=1")
    inj.before_call("u.lad")  # bare stage untouched
    with pytest.raises(pkg.res.InjectedFault):
        inj.before_call("u.lad/cpu_fallback")
    inj.clear()
    inj.install("stage=u.wild*;at=1")
    with pytest.raises(pkg.res.InjectedFault):
        inj.before_call("u.wildcard.anything")
    return inj.plans()


def sc_injector_corrupt_mode(pkg):
    pkg.res.injector.install("stage=u.c;mode=corrupt;at=1")
    with pytest.raises(pkg.res.InjectedFault) as ei:
        pkg.res.injector.before_call("u.c")
    assert pkg.res.classify(ei.value) == pkg.res.FaultKind.CORRUPTION
    return str(ei.value)


def sc_injector_env_gating(pkg):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv(pkg.res.INJECT_ENV_VAR, "stage=u.env;mode=raise;at=1")
        pkg.res.injector.reload_env()
        assert pkg.res.injector.active()
        with pytest.raises(pkg.res.InjectedFault):
            pkg.res.injector.before_call("u.env")
        mp.delenv(pkg.res.INJECT_ENV_VAR)
        pkg.res.injector.reload_env()
        assert not pkg.res.injector.active()
    finally:
        mp.undo()
    return pkg.res.INJECT_ENV_VAR


def sc_injector_bad_spec_rejected(pkg):
    msgs = []
    for spec in ("mode=raise;at=1", "stage=x;mode=explode"):
        with pytest.raises(ValueError) as ei:
            pkg.res.injector.install(spec)
        msgs.append(str(ei.value))
    return msgs


# -- supervisor / health machine ---------------------------------------------------


def _ladder(calls):
    def full():
        calls["full"] += 1
        return "full"

    def reduced():
        calls["reduced"] += 1
        return "reduced"

    def fb():
        calls["fb"] += 1
        return "fb"

    return (("device_full", full), ("device_reduced", reduced), ("cpu_fallback", fb))


def _calls():
    return dict.fromkeys(("full", "reduced", "fb"), 0)


def sc_transient_retried_in_place(pkg):
    tr = _Trace(pkg, ["u.retry"])
    sup = pkg.res.BackendSupervisor("u.retry", _fast_config(pkg))
    n = {"i": 0}

    def flaky():
        n["i"] += 1
        if n["i"] < 3:
            raise ConnectionError("reset by peer")
        return "ok"

    tr.step(sup, sup.run_ladder("u.r", (("device_full", flaky),)))
    assert tr.steps[-1][0] == "ok"
    assert sup.retries == 2 and sup.state == pkg.res.HealthState.HEALTHY
    assert sup.demotions == 0
    return tr.done(snapshot=sup.snapshot())


def sc_retries_bounded_then_descend(pkg):
    tr = _Trace(pkg, ["u.bound"])
    sup = pkg.res.BackendSupervisor("u.bound", _fast_config(pkg, max_retries=1))
    calls = _calls()
    attempts = {"n": 0}

    def always_transient():
        attempts["n"] += 1
        raise ConnectionError("reset")

    rungs = (("device_full", always_transient),) + _ladder(calls)[1:]
    tr.step(sup, sup.run_ladder("u.b", rungs))
    assert tr.steps[-1][0] == "reduced"
    assert attempts["n"] == 2  # 1 try + max_retries=1, no more
    assert sup.state == pkg.res.HealthState.DEGRADED
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def sc_oom_demotes_without_retry(pkg):
    tr = _Trace(pkg, ["u.oom"])
    sup = pkg.res.BackendSupervisor("u.oom", _fast_config(pkg))
    calls = _calls()
    tries = {"n": 0}

    def oom():
        tries["n"] += 1
        raise MemoryError()

    rungs = (("device_full", oom),) + _ladder(calls)[1:]
    tr.step(sup, sup.run_ladder("u.o", rungs))
    assert tr.steps[-1][0] == "reduced"
    assert tries["n"] == 1          # same-shape retry is futile
    assert sup.demotions == 1 and sup.fallback_calls == 1
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def sc_corruption_jumps_to_cpu(pkg):
    tr = _Trace(pkg, ["u.cor"])
    sup = pkg.res.BackendSupervisor("u.cor", _fast_config(pkg))
    calls = _calls()

    def corrupt():
        raise AssertionError("limb bound assert tripped")

    rungs = (("device_full", corrupt),) + _ladder(calls)[1:]
    tr.step(sup, sup.run_ladder("u.c", rungs))
    assert tr.steps[-1][0] == "fb"
    assert calls["reduced"] == 0    # nothing device-shaped is trusted
    assert sup.state == pkg.res.HealthState.QUARANTINED
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def sc_degrade_quarantine_probation_repromote(pkg):
    tr = _Trace(pkg, ["u.cycle"])
    sup = pkg.res.BackendSupervisor("u.cycle", _fast_config(pkg, probation_s=0.6))
    calls = _calls()
    broken = {"on": True}

    def full():
        calls["full"] += 1
        if broken["on"]:
            raise MemoryError()
        return "full"

    rungs = (("device_full", full),) + _ladder(calls)[1:]
    tr.step(sup, sup.run_ladder("u.y", rungs))
    assert tr.steps[-1][0] == "reduced"
    assert sup.state == pkg.res.HealthState.DEGRADED
    # the probe (every probe_every-th call) fails too -> quarantine
    for _ in range(3):
        tr.step(sup, sup.run_ladder("u.y", rungs))
    assert sup.state == pkg.res.HealthState.QUARANTINED
    # quarantined: straight to the fallback, device untouched
    n_full = calls["full"]
    tr.step(sup, sup.run_ladder("u.y", rungs))
    assert tr.steps[-1][0] == "fb"
    assert calls["full"] == n_full
    # device heals; probation expires; probe -> DEGRADED -> HEALTHY
    broken["on"] = False
    time.sleep(sup.config.probation_s + 0.1)
    for _ in range(6):
        tr.step(sup, sup.run_ladder("u.y", rungs))
    assert "full" in [r for r, _ in tr.steps[-6:]]
    assert sup.state == pkg.res.HealthState.HEALTHY, sup.snapshot()
    assert sup.promotions >= 2 and sup.demotions >= 2
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def sc_exhausted_ladder_fails_closed(pkg):
    tr = _Trace(pkg, ["u.exh"])
    sup = pkg.res.BackendSupervisor("u.exh", _fast_config(pkg, max_retries=0))

    def boom():
        raise MemoryError()

    with pytest.raises(pkg.res.SupervisedFault):
        sup.run_ladder("u.e", (("device_full", boom), ("cpu", boom)))
    assert sup.exhausted == 1
    return tr.done(snapshot=sup.snapshot())


def sc_hang_goes_to_watchdog_and_descends(pkg):
    tr = _Trace(pkg, ["u.hang"])
    sup = pkg.res.BackendSupervisor("u.hang", _fast_config(pkg, deadline_s=0.05))
    calls = _calls()
    release = threading.Event()

    def wedged():
        release.wait(1.0)
        return "late"

    rungs = (("device_full", wedged),) + _ladder(calls)[1:]
    try:
        tr.step(sup, sup.run_ladder("u.h", rungs))
    finally:
        release.set()
    assert tr.steps[-1][0] == "reduced"
    assert sup.watchdog_timeouts == 1
    assert sup.state == pkg.res.HealthState.DEGRADED
    rec = pkg.res.recent_faults(4)[-1]
    assert rec["kind"] == "hang" and rec["domain"] == "u.hang"
    _wait_for(lambda: sup.snapshot()["hung_threads"] == 0)
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def _wait_for(cond, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


def sc_hung_thread_cap_hard_quarantines(pkg):
    tr = _Trace(pkg, ["u.cap"])
    sup = pkg.res.BackendSupervisor(
        "u.cap", _fast_config(pkg, deadline_s=0.02, max_hung_threads=2, probation_s=0.01),
    )
    release = threading.Event()
    calls = _calls()

    def wedged_forever():
        release.wait(5.0)

    rungs = (("device_full", wedged_forever),) + _ladder(calls)[1:]
    try:
        for _ in range(4):
            time.sleep(0.02)  # let probation expire so the device is re-probed
            tr.step(sup, sup.run_ladder("u.k", rungs))
        snap = sup.snapshot()
        assert snap["hard_quarantined"]
        assert snap["watchdog_timeouts"] == 2  # capped: no more device probes
        assert not sup.device_allowed()
        # under hard quarantine a ladder with NO device-free (cpu*) rung
        # fails closed instead of feeding another thread into the wedge
        with pytest.raises(pkg.res.SupervisedFault):
            sup.run_ladder(
                "u.k", (("device_full", wedged_forever), ("device_reduced", wedged_forever)),
            )
    finally:
        release.set()
    # once the stranded calls return, the hard quarantine lifts
    _wait_for(lambda: not sup.snapshot()["hard_quarantined"])
    _wait_for(lambda: sup.snapshot()["hung_threads"] == 0)
    return tr.done(snapshot=sup.snapshot(), calls=calls)


def sc_seeded_backoff_is_deterministic(pkg):
    a = pkg.res.BackendSupervisor("u.da", _fast_config(pkg, seed=7))
    b = pkg.res.BackendSupervisor("u.db", _fast_config(pkg, seed=7))
    seq = [a._backoff(i) for i in (1, 2, 3)]
    assert seq == [b._backoff(i) for i in (1, 2, 3)]
    return seq


def sc_injection_targets_primary_rung_only(pkg):
    tr = _Trace(pkg, ["u.inj"])
    sup = pkg.res.BackendSupervisor("u.inj", _fast_config(pkg))
    calls = _calls()
    pkg.res.injector.install("stage=u.i;mode=raise;kind=oom;every=1")
    tr.step(sup, sup.run_ladder("u.i", _ladder(calls)))
    assert tr.steps[-1][0] == "reduced"
    assert calls["full"] == 0
    return tr.done(snapshot=sup.snapshot(), calls=calls)


# -- firehose under injected device faults -----------------------------------------


class _ItemVerifier:
    """Batched fake verifier over ('id',) items; ids in ``bad`` fail."""

    def __init__(self, bad=()):
        self.bad = set(bad)
        self.calls = []

    def __call__(self, items):
        self.calls.append(len(items))
        return not any(it[0] in self.bad for it in items)


def _engine(pkg, verifier, sup, fallback=None, max_batch=4):
    return pkg.fh.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps],
        verify_items_fn=verifier,
        config=pkg.fh.FirehoseConfig(max_batch=max_batch),
        synchronous=True,
        supervisor=sup,
        fallback_verify_fn=fallback,
    )


def _run_items(engine, n):
    verdicts = {}
    for i in range(n):
        engine.submit(i, callback=lambda p, ok, m: verdicts.__setitem__(p, ok))
    engine.drain()
    return verdicts


def _stats(engine) -> dict:
    d = engine.stats().as_dict()
    for k in ("p50_latency_s", "p99_latency_s", "p50_e2e_s", "p99_e2e_s"):
        d[k] = d[k] is not None  # times differ; their presence must not
    return d


def sc_transient_faults_invisible_to_verdicts(pkg):
    tr = _Trace(pkg, ["fh.t"])
    sup = pkg.res.BackendSupervisor("fh.t", _fast_config(pkg))
    vf = _ItemVerifier()
    pkg.res.injector.install("stage=firehose.device_verify;mode=raise;kind=transient;every=2")
    engine = _engine(pkg, vf, sup)
    verdicts = _run_items(engine, 12)
    assert all(verdicts[i] for i in range(12))
    assert sup.retries >= 1 and engine.stats().device_faults == 0
    return tr.done(verdicts=verdicts, calls=vf.calls, stats=_stats(engine),
                   snapshot=sup.snapshot())


def sc_bisection_under_repeated_device_faults(pkg):
    bad = {3, 9}
    tr = _Trace(pkg, ["fh.b"])
    sup = pkg.res.BackendSupervisor("fh.b", _fast_config(pkg))
    vf = _ItemVerifier(bad)
    pkg.res.injector.install("stage=firehose.device_verify;mode=raise;kind=transient;every=3")
    engine = _engine(pkg, vf, sup)
    verdicts = _run_items(engine, 16)
    assert verdicts == {i: i not in bad for i in range(16)}
    st = engine.stats()
    assert st.verified == 14 and st.rejected == 2 and st.errored == 0
    assert sup.retries <= sup.faults_seen * sup.config.max_retries
    assert sup.exhausted == 0
    return tr.done(verdicts=verdicts, calls=vf.calls, stats=_stats(engine),
                   snapshot=sup.snapshot())


def sc_oom_ladder_demotes_then_repromotes(pkg):
    tr = _Trace(pkg, ["fh.o"])
    sup = pkg.res.BackendSupervisor("fh.o", _fast_config(pkg, promote_after=1, probe_every=2))
    vf = _ItemVerifier()
    served_fallback = []

    def fallback(items):
        served_fallback.append(len(items))
        return True

    pkg.res.injector.install("stage=firehose.device_verify;mode=raise;kind=oom;at=1;times=1")
    engine = _engine(pkg, vf, sup, fallback=fallback)
    verdicts = _run_items(engine, 16)
    assert all(verdicts[i] for i in range(16))
    assert sup.demotions >= 1 and sup.promotions >= 1
    assert sup.state == pkg.res.HealthState.HEALTHY
    assert engine.resilience()["demotions"] >= 1
    return tr.done(verdicts=verdicts, calls=vf.calls, fallback=served_fallback,
                   stats=_stats(engine), snapshot=sup.snapshot())


def sc_corruption_serves_from_cpu_fallback_only(pkg):
    tr = _Trace(pkg, ["fh.c"])
    sup = pkg.res.BackendSupervisor("fh.c", _fast_config(pkg))
    vf = _ItemVerifier()
    fb = _ItemVerifier(bad={5})
    pkg.res.injector.install("stage=firehose.device_verify;mode=corrupt;every=1")
    engine = _engine(pkg, vf, sup, fallback=fb)
    verdicts = _run_items(engine, 8)
    assert verdicts == {i: i != 5 for i in range(8)}
    assert vf.calls == []  # the device rung never served anything
    assert sup.state == pkg.res.HealthState.QUARANTINED
    return tr.done(verdicts=verdicts, calls=fb.calls, stats=_stats(engine),
                   snapshot=sup.snapshot())


def sc_exhausted_ladder_counts_errored(pkg):
    tr = _Trace(pkg, ["fh.x", "firehose"])
    sup = pkg.res.BackendSupervisor("fh.x", _fast_config(pkg, max_retries=0))
    vf = _ItemVerifier()
    pkg.res.injector.install(
        "stage=firehose.device_verify;mode=raise;kind=oom;every=1|"
        "stage=firehose.device_verify/device_reduced;mode=raise;kind=oom;every=1"
    )
    engine = _engine(pkg, vf, sup)  # no CPU fallback rung attached
    verdicts = _run_items(engine, 4)
    assert verdicts == dict.fromkeys(range(4), False)
    st = engine.stats()
    assert st.errored == 4 and st.device_faults >= 1
    assert "firehose.verify_batch" in {r["stage"] for r in pkg.res.recent_faults(16)}
    return tr.done(verdicts=verdicts, calls=vf.calls, stats=_stats(engine),
                   snapshot=sup.snapshot())


def sc_stop_enforces_hard_join_deadline(pkg):
    release = threading.Event()

    def wedged(items):
        release.wait(timeout=20.0)
        return True

    engine = pkg.fh.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps],
        verify_items_fn=wedged,
        config=pkg.fh.FirehoseConfig(max_batch=2, deadline_s=0.001),
    )
    try:
        for i in range(8):
            engine.submit(i)
        t0 = time.monotonic()
        clean = engine.stop(drain_timeout=0.5)
        dt = time.monotonic() - t0
        assert not clean            # the wedge was detected, not waited out
        assert dt < 5.0
        assert "firehose.shutdown" in [r["stage"] for r in pkg.res.recent_faults(16)]
        prep = [t for t in engine._threads if "prep" in t.name]
        for t in prep:
            t.join(timeout=2.0)
        assert not any(t.is_alive() for t in prep)
    finally:
        release.set()
        for t in engine._threads:
            t.join(timeout=5.0)
    return clean


def sc_watchdog_reclaims_hung_device_call(pkg):
    tr = _Trace(pkg, ["fh.h"])
    sup = pkg.res.BackendSupervisor("fh.h", _fast_config(pkg, deadline_s=0.05))
    fb = _ItemVerifier()
    pkg.res.injector.install("stage=firehose.device_verify;mode=hang;hang_s=1.0;every=1;times=1")
    engine = _engine(pkg, _ItemVerifier(), sup, fallback=fb)
    t0 = time.monotonic()
    verdicts = _run_items(engine, 4)
    assert time.monotonic() - t0 < 5.0
    assert all(verdicts[i] for i in range(4))
    assert sup.watchdog_timeouts == 1
    _wait_for(lambda: sup.snapshot()["hung_threads"] == 0)
    return tr.done(verdicts=verdicts, calls=fb.calls, stats=_stats(engine),
                   snapshot=sup.snapshot())


SCENARIOS = {
    f.__name__[3:]: f
    for f in (
        sc_type_first_classification, sc_marker_classification,
        sc_subprocess_note_classification, sc_injected_fault_carries_kind,
        sc_record_ring_and_metrics, sc_watchdog_passthrough, sc_watchdog_hang_detection,
        sc_injector_every_and_times, sc_injector_at_nth_call_only,
        sc_injector_wildcard_and_rung_targeting, sc_injector_corrupt_mode,
        sc_injector_env_gating, sc_injector_bad_spec_rejected,
        sc_transient_retried_in_place, sc_retries_bounded_then_descend,
        sc_oom_demotes_without_retry, sc_corruption_jumps_to_cpu,
        sc_degrade_quarantine_probation_repromote, sc_exhausted_ladder_fails_closed,
        sc_hang_goes_to_watchdog_and_descends, sc_hung_thread_cap_hard_quarantines,
        sc_seeded_backoff_is_deterministic, sc_injection_targets_primary_rung_only,
        sc_transient_faults_invisible_to_verdicts,
        sc_bisection_under_repeated_device_faults, sc_oom_ladder_demotes_then_repromotes,
        sc_corruption_serves_from_cpu_fallback_only, sc_exhausted_ladder_counts_errored,
        sc_stop_enforces_hard_join_deadline, sc_watchdog_reclaims_hung_device_call,
    )
}
# the hung-thread cap scenario's rung sequence depends on when its stranded
# threads return; every other trace is a function of the scenario alone
SAME_TRACE = [n for n in SCENARIOS if n != "hung_thread_cap_hard_quarantines"]
TRACES: dict = {}


def _run(name: str, which: str):
    """One scenario on one package, from inert injection, HEALTHY
    supervisors and an empty fault ring, with the package's configs
    restored afterwards (as the reference test's autouse fixture does)."""
    pkg = PKGS[which]
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGHTHOUSE_RESILIENCE_SEED", SEED)
    pkg.res.injector.clear()
    saved = {n: dataclasses.replace(s.config) for n, s in pkg.res.all_supervisors().items()}
    pkg.res.reset_all()
    pkg.faults.clear_fault_log()
    try:
        TRACES[(name, which)] = SCENARIOS[name](pkg)
    finally:
        for n, sup in pkg.res.all_supervisors().items():
            sup.config = saved.get(n, pkg.res.SupervisorConfig())
        pkg.res.injector.clear()
        pkg.res.reset_all()
        mp.undo()
    return TRACES[(name, which)]


@pytest.mark.parametrize("which", ["ref", "port"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario(name, which):
    _run(name, which)


@pytest.mark.parametrize("name", SAME_TRACE)
def test_port_trace_equals_reference(name):
    """Same results, rung sequence, health states, snapshot, fault ring and
    counter deltas as the reference on the same scenario."""
    ref = TRACES.get((name, "ref")) or _run(name, "ref")
    port = TRACES.get((name, "port")) or _run(name, "port")
    assert port == ref


def test_cuda_errors_are_classified():
    """Sticky CUDA errors and the kernels' launch failures are CORRUPTION
    (the context is dead: no retry on it); CUDA OOM stays OOM; the XLA
    markers keep their kinds."""
    FK, classify = p_res.FaultKind, p_res.classify

    class AcceleratorError(RuntimeError):
        pass

    class OutOfMemoryError(RuntimeError):
        pass

    sticky = [
        "CUDA error: an illegal memory access was encountered\nCUDA kernel errors "
        "might be asynchronously reported at some other API call, so the stacktrace "
        "below might be incorrect.",
        "CUDA error: unspecified launch failure",
        "CUDA error: device-side assert triggered",
        "CUDA error: misaligned address",
        "CUDA error: an illegal instruction was encountered",
        "plan kernel launch failed: CUDA error 700",
        "chain kernel launch failed: CUDA error 719",
    ]
    for msg in sticky:
        assert classify(RuntimeError(msg)) == FK.CORRUPTION, msg
        assert classify(AcceleratorError(msg)) == FK.CORRUPTION, msg
    # a launch wrapper's non-sticky code (invalid configuration, too many
    # resources requested, invalid value) leaves the context usable: the
    # marker rules decide, so the ladder retries and tries its reduced shape
    for code in (1, 9, 98, 701, 720):
        for kernel in ("plan", "chain"):
            msg = f"{kernel} kernel launch failed: CUDA error {code}"
            assert classify(RuntimeError(msg)) == FK.TRANSIENT, msg
    assert classify(RuntimeError("plan kernel launch failed: CUDA error 2 (out of memory)")) == (
        FK.OOM
    )
    # a timeout word in a sticky error's text does not make it a hang
    assert p_res.classify_text("unspecified launch failure (timeout)") == FK.CORRUPTION
    oom = OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity "
        "of 79.19 GiB of which 1.06 GiB is free."
    )
    assert classify(oom) == FK.OOM
    assert classify(ConnectionError("reset by peer")) == FK.TRANSIENT
    # the reference classifies the sticky texts as transient (XLA markers only)
    assert r_res.classify(RuntimeError("CUDA error: unspecified launch failure")) == (
        r_res.FaultKind.TRANSIENT
    )


@pytest.mark.parametrize("code, rung", [(9, "reduced"), (700, None), (719, None)])
def test_kernel_launch_failure_ladder(code, rung):
    """A launch wrapper's failure walks the ladder by its code: a
    shape-dependent one (9, an invalid launch configuration) is retried and
    then served by the reduced rung; a sticky one skips every device rung
    and, with no CPU rung, fails closed."""
    sup = p_res.BackendSupervisor(f"u.launch{code}", _fast_config(PKGS["port"]))
    calls = _calls()
    tries = {"n": 0}

    def full():
        tries["n"] += 1
        raise RuntimeError(f"plan kernel launch failed: CUDA error {code}")

    rungs = (("device_full", full), _ladder(calls)[1])
    if rung is None:
        with pytest.raises(p_res.SupervisedFault):
            sup.run_ladder("u.l", rungs)
        assert tries["n"] == 1 and calls["reduced"] == 0
        assert sup.state == p_res.HealthState.QUARANTINED
    else:
        assert sup.run_ladder("u.l", rungs) == rung
        assert tries["n"] == 3 and sup.retries == 2 and calls["reduced"] == 1


def test_sticky_cuda_error_fails_closed():
    """A sticky CUDA error on the device rung: no retry, no reduced rung on
    the dead context; without a CPU rung the ladder exhausts and every item
    of the batch gets False, counted as errored, with a classified fault."""
    p_res.injector.clear()
    p_faults.clear_fault_log()
    sup = p_res.BackendSupervisor("fh.sticky", _fast_config(PKGS["port"]))
    calls = []

    def dead_context(items):
        calls.append(len(items))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    engine = _engine(PKGS["port"], dead_context, sup)
    verdicts = _run_items(engine, 4)
    assert verdicts == dict.fromkeys(range(4), False)
    assert calls == [4]                       # one attempt: no retry, no halves
    snap = sup.snapshot()
    assert snap["retries"] == 0 and snap["exhausted"] == 1
    assert snap["state"] == "QUARANTINED"
    st = engine.stats()
    assert st.errored == 4 and st.device_faults == 1 and st.verified == 0
    kinds = [(r["stage"], r["kind"]) for r in p_res.recent_faults(8)]
    assert ("firehose.device_verify", "corruption") in kinds
    assert ("firehose.verify_batch", "corruption") in kinds
