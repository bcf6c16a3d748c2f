"""Helpers the metric readers share: what a run's window holds.

A reader (``benchmark/metrics/<name>.py``) gets one ``Context``; a call is
the benchmark's span around one verify call, ``(start, end, sets, keys,
payloads, verdict)``.
"""

from __future__ import annotations

import os

from .spec import HERE, load_json


class Context:
    def __init__(self, cell, traffic, window, recorder, setup_s, launches=None, trace=None):
        self.cell, self.traffic, self.window = cell, traffic, window
        self.recorder = recorder
        self.setup_s = setup_s
        self.launches = launches
        self.trace = trace


def calls_started(ctx) -> list:
    """Verify calls that started inside the window."""
    w = ctx.window
    return [c for c in ctx.recorder.calls if w.t0 <= c[0] < w.t_end]


def calls_inside(ctx) -> list:
    """Verify calls that started and ended inside the window."""
    w = ctx.window
    return [c for c in ctx.recorder.calls if w.t0 <= c[0] and c[1] <= w.t_end]


def subs_due(ctx) -> list:
    """Submissions due inside the window."""
    w = ctx.window
    return [s for s in w.subs if w.t0 <= s.due < w.t_end]


def sets_answered(ctx) -> int:
    """Signature sets whose payload's verdict came inside the window."""
    w = ctx.window
    return sum(s.sets for s in w.subs if s.done is not None and w.t0 <= s.done <= w.t_end)


def roofline_work() -> dict:
    return load_json(os.path.join(HERE, "metrics", "roofline_work.json"))
