"""att.verdict_p95_ms: the 95th percentile (nearest rank), over every payload
due inside the window, of the milliseconds from its due time to its verdict
callback. A payload the intake shed or that never got a verdict counts as
infinitely late; a percentile that falls on one reads 1e9 ms."""

import math

from benchmark.harness.readings import subs_due

UNANSWERED_MS = 1e9


def read(ctx):
    subs = subs_due(ctx)
    if not subs:
        return None
    lat = sorted((s.done - s.due) * 1e3 if s.done is not None else math.inf for s in subs)
    v = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return v if math.isfinite(v) else UNANSWERED_MS
