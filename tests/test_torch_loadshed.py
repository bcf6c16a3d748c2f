"""The port's overload protection against the reference's.

``lighthouse_tpu_torch.loadshed`` (and the rate limiter and peer manager
of its network package) are the port's copies of the reference's host
policies. The same inputs, under the same fake clock and the same seeds,
must give the same admission levels and transitions, deadlines, shed
decisions, RTT timeouts, self-limiter waits, backoff cooldowns and bans.
Exact equality (the arithmetic is the same Python float arithmetic).
"""

from lighthouse_tpu import loadshed as r_ls
from lighthouse_tpu.beacon_processor import BeaconProcessor as RProcessor
from lighthouse_tpu.beacon_processor import Work as RWork
from lighthouse_tpu.beacon_processor import WorkType as RWorkType
from lighthouse_tpu.network import peer_manager as r_pm
from lighthouse_tpu.network import rate_limiter as r_rl
from lighthouse_tpu_torch import loadshed as p_ls
from lighthouse_tpu_torch.beacon_processor import BeaconProcessor as PProcessor
from lighthouse_tpu_torch.beacon_processor import Work as PWork
from lighthouse_tpu_torch.beacon_processor import WorkType as PWorkType
from lighthouse_tpu_torch.network import peer_manager as p_pm
from lighthouse_tpu_torch.network import rate_limiter as p_rl

PKGS = {
    "ref": (r_ls, RProcessor, RWork, RWorkType, r_pm, r_rl),
    "port": (p_ls, PProcessor, PWork, PWorkType, p_pm, p_rl),
}


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    want, got = fn(*PKGS["ref"]), fn(*PKGS["port"])
    assert got == want
    return got


def test_tables_and_deadlines_equal():
    def run(ls, _p, _w, WorkType, _pm, _rl):
        names = [t.name for t in WorkType]
        return {
            "p0": sorted(ls.P0_ROUTES), "methods": dict(ls.METHOD_PRIORITY),
            "budgets": [ls.budget_for(n, 6.0) for n in names + ["Status", "nope"]],
            "deadlines": [ls.deadline_for(t, now=50.0) for t in WorkType],
            "expired": [ls.expired(d, 61.0) for d in (None, 60.0, 61.0, 62.0)],
            "shed": [(m, int(lv), ls.should_shed_method(m, lv), ls.shed_floor(lv))
                     for m in list(ls.METHOD_PRIORITY) + ["unlisted"]
                     for lv in ls.AdmissionLevel],
            "routes": [ls.is_p0_route(r) for r in ("attester", "node_version", "health")],
        }

    got = _both(run)
    assert got["budgets"][-1] is None and got["expired"] == [False, True, False, False]


def test_admission_levels_and_transitions_equal():
    """One processor filled, drained and dropped under a fake clock, a
    resilience snapshot that degrades then quarantines, a failing source:
    the same level after every step."""
    def run(ls, Processor, Work, WorkType, _pm, _rl):
        clock = Clock()
        proc = Processor(synchronous=False)
        proc.shutdown()
        mon = ls.LoadMonitor(clock=clock)
        mon.attach_processor(proc)
        snaps = {"bls": {"state": "HEALTHY"}}
        mon.attach_supervisors(lambda: snaps)
        levels = []

        def step(dt=1.0):
            clock.t += dt
            levels.append(int(mon.level()))

        step()
        limit = proc.config.queue_lengths.limit(WorkType.GossipAttestation)
        for i in range(limit // 2 + 1):
            proc.submit(Work(WorkType.GossipAttestation, i, process_batch=lambda xs: None))
        step()
        for i in range(limit):
            proc.submit(Work(WorkType.GossipAttestation, i, process_batch=lambda xs: None))
        step()
        proc.run_until_idle()
        step()
        step()
        snaps["bls"] = {"state": "DEGRADED"}
        step()
        snaps["bls"] = {"state": "QUARANTINED"}
        step()
        step(0.01)  # inside the sample interval: the cached level
        snaps["bls"] = {"state": "HEALTHY"}
        step()
        mon.add_source("broken", lambda: 1 / 0)
        step()
        mon.force_level(ls.AdmissionLevel.BUSY)
        step()
        mon.force_level(None)
        step()
        return {"levels": levels, "transitions": [t[1:] for t in mon.transitions()],
                "summary": mon.summary()}

    got = _both(run)
    assert 2 in got["levels"] and got["summary"]["sample_failures"] >= 1


def test_rtt_estimator_sequence_equal():
    def run(ls, *_):
        est = ls.RttEstimator(max_timeout=5.0)
        out = [est.timeout()]
        for rtt in (0.05, 0.07, 0.3, 0.02, 1.5, 0.04):
            est.observe(rtt)
            out.append(est.timeout())
        for _ in range(6):
            est.on_timeout()
            out.append(est.timeout())
        est.observe(0.01)
        out.append((est.timeout(), est.srtt, est.rttvar, est.samples))
        return out

    _both(run)


def test_backoff_policy_seeded_sequence_equal():
    def run(ls, *_):
        clock = Clock()
        pol = ls.BackoffPolicy(seed=1234, clock=clock)
        out = []
        for i in range(5):
            out.append(pol.record_failure("a"))
            out.append((pol.ready("a"), pol.cooldown_remaining("a"), pol.failures("a")))
            clock.t += 0.5
            out.append(pol.attempt_delay(i))
        pol.record_success("a")
        out.append((pol.ready("a"), pol.failures("a")))
        out.append(pol.record_failure("b"))
        pol.forget("b")
        out.append(pol.ready("b"))
        return out

    _both(run)


def test_self_limiter_and_rate_limiter_sequence_equal():
    def run(ls, _p, _w, _t, _pm, rl):
        clock = Clock()
        lim = ls.SelfLimiter(clock=clock)
        srv = rl.RateLimiter(clock=clock)
        out = []
        for step in range(40):
            method = ("status", "blocks_by_range", "blocks_by_root", "ping")[step % 4]
            payload = {"blocks_by_range": (0, 300), "blocks_by_root": [b"x"] * 50}.get(method)
            cost = rl.request_cost(method, payload)
            out.append((method, cost, lim.throttle("p", method, cost), lim.wait_time("p", method, cost),
                        srv.allow("p", method, cost), srv.wait_time("p", method, cost)))
            clock.t += 0.7
        out.append(srv.wait_time("p", "blocks_by_range", 5000.0))
        clock.t += 120.0
        out.append((srv.maybe_prune(), len(srv._buckets)))
        return out

    got = _both(run)
    assert got[-2] == float("inf")


def test_peer_manager_bans_equal():
    def run(_ls, _p, _w, _t, pm, _rl):
        clock = Clock()
        mgr = pm.PeerManager(clock=clock)
        out = [mgr.on_connect("a", node_id=b"\x01")]
        for _ in range(6):
            out.append((mgr.report("a", -20.0), mgr.state("a"), mgr.is_banned("a")))
        out.append((mgr.on_connect("a"), mgr.is_banned(node_id=b"\x01")))
        clock.t += pm.BAN_DURATION + 1
        out.append((mgr.is_banned("a"), mgr.score("a"), mgr.state("a")))
        mgr.decay_scores()
        out.append((mgr.score("a"), mgr.summary(), mgr.connected()))
        return out

    got = _both(run)
    assert got[6][1] == "banned"
