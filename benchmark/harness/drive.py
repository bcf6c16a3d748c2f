"""The measured window: the program's firehose driven by one mix.

The benchmark hands ``lighthouse_tpu_torch.firehose.FirehoseEngine`` (threaded
mode: the intake, its prep thread and its device thread) a ``prepare_fn`` of
its own, which maps a payload to its signature-set group as the chain's
committee lookup would, and a ``verify_items_fn`` that calls the program's
verify entry and records a span around each call. Each payload is one
``Sub`` (one submission); its verdict callback stamps the time.

* Closed loop: the intake is topped up to ``intake_depth`` payloads from the
  cycled pool after each verdict (at least every ``TOP_UP_WAIT_S``); a
  payload's due time is its submission.
* Open loop: each payload is submitted at its due time, those due after
  the window's end too; the generator's lateness is the submission's delay
  past it.

Every clock here is ``time.monotonic()``.
"""

from __future__ import annotations

import threading
import time

clock = time.monotonic
# the closed loop tops the intake up when a verdict comes, or after this long:
# the intake holds a batch in reserve beyond the one the prep thread takes
# next, so a late top-up never starves it, and the generator seldom takes
# the interpreter lock from the thread that dispatches
TOP_UP_WAIT_S = 0.05


class Sub:
    """One submission of one entry."""

    __slots__ = ("seq", "entry", "due", "submitted", "accepted", "first_call", "done", "ok",
                 "sets", "keys", "ids")

    def __init__(self, seq: int, entry: int, due: float, sets: int, keys: int):
        self.seq, self.entry, self.due = seq, entry, due
        self.sets, self.keys = sets, keys
        self.submitted = None
        self.accepted = False
        self.first_call = None
        self.done = None
        self.ok = None
        self.ids = ()


class Recorder:
    """The benchmark's own spans: one per verify call (start, end, sets,
    keys, payloads, verdict) and one per prepare call (start, end)."""

    def __init__(self, traffic):
        self.traffic = traffic
        self.calls: list = []
        self.preps: list = []
        self._owner: dict = {}
        self.answered = threading.Event()

    def prepare_fn(self, payloads):
        t = clock()
        out = []
        for sub in payloads:
            group = [(ix, m, s) for ix, m, s in self.traffic.entries[sub.entry].group]
            sub.ids = tuple(id(it) for it in group)
            for it in group:
                self._owner[id(it)] = sub
            out.append((group, sub))
        self.preps.append((t, clock()))
        return out

    def verify_fn(self, inner):
        """``inner(items) -> bool`` wrapped in a span."""

        def verify_items(items):
            t = clock()
            subs = {}
            keys = 0
            for it in items:
                keys += len(it[0])
                sub = self._owner.get(id(it))
                if sub is not None:
                    subs[id(sub)] = sub
                    if sub.first_call is None:
                        sub.first_call = t
            ok = inner(items)
            self.calls.append((t, clock(), len(items), keys, len(subs), bool(ok)))
            return ok

        return verify_items

    def verdict(self, sub, ok, meta=None):
        sub.done = clock()
        sub.ok = bool(ok)
        for i in sub.ids:
            self._owner.pop(i, None)
        self.answered.set()


class Window:
    """What one window produced."""

    def __init__(self):
        self.t0 = self.t_end = 0.0
        self.seconds = 0.0
        self.subs: list = []
        self.lateness: list = []


def make_engine(traffic, recorder, inner_verify):
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine

    return FirehoseEngine(
        prepare_fn=recorder.prepare_fn,
        verify_items_fn=recorder.verify_fn(inner_verify),
        config=FirehoseConfig(max_batch=traffic.batch_limit),
    )


def _submit(engine, traffic, recorder, sub, work_type):
    sub.submitted = clock()
    sub.accepted = engine.submit(sub, work_type=work_type, callback=recorder.verdict)


def _sleep_until(t: float) -> None:
    d = t - clock()
    if d > 0:
        time.sleep(d)


def run_window(engine, traffic, recorder, seconds: float, on_start=None, on_close=None) -> Window:
    """Drive the engine for ``seconds`` from now, then wait (at most the
    mix's ``wait_s``) for the verdicts still owed, and stop the engine.
    ``on_start``/``on_close`` run just before the first submission and at
    the window's end (the counters' marks). An open loop goes on submitting
    the payloads its mix has due after the window's end."""
    from lighthouse_tpu_torch.beacon_processor.processor import WorkType

    wt = WorkType[traffic.work_type]
    w = Window()
    w.seconds = seconds
    if on_start is not None:
        on_start()
    w.t0 = clock()
    w.t_end = w.t0 + seconds
    closed = False

    def close():
        _sleep_until(w.t_end)
        if on_close is not None:
            on_close()
        return True

    if traffic.loop == "closed":
        seq = 0
        while True:
            now = clock()
            if now >= w.t_end:
                break
            recorder.answered.clear()
            depth = engine.batcher.depth()
            while depth < traffic.intake_depth:
                e = traffic.entry_at(seq)
                ent = traffic.entries[e]
                sub = Sub(seq, e, clock(), ent.sets, ent.keys)
                _submit(engine, traffic, recorder, sub, wt)
                w.subs.append(sub)
                seq += 1
                depth += 1
            recorder.answered.wait(min(TOP_UP_WAIT_S, max(0.0, w.t_end - clock())))
    else:
        for e, off in enumerate(traffic.due):
            due = w.t0 + off
            if not closed and due >= w.t_end:
                closed = close()
            _sleep_until(due)
            ent = traffic.entries[e]
            sub = Sub(e, e, due, ent.sets, ent.keys)
            _submit(engine, traffic, recorder, sub, wt)
            w.lateness.append(sub.submitted - due)
            w.subs.append(sub)
    if not closed:
        close()
    give_up = clock() + traffic.wait_s
    while clock() < give_up and any(s.accepted and s.done is None for s in w.subs):
        time.sleep(0.01)
    engine.stop(drain_timeout=max(1.0, give_up - clock()))
    return w
