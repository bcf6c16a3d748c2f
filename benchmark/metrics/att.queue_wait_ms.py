"""att.queue_wait_ms: mean milliseconds from a payload's due time to the
start of the first verify call that carries it, over the payloads due in
the window that reached a call (the intake's and the prep thread's wait)."""

from benchmark.harness.readings import subs_due


def read(ctx):
    waits = [(s.first_call - s.due) * 1e3 for s in subs_due(ctx) if s.first_call is not None]
    return sum(waits) / len(waits) if waits else None
