"""verify_call_ms.agg: wall milliseconds a verify call takes (the call ends
in the verdict's read), over every call that started in the traced window."""

from benchmark.harness.readings import calls_started


def read(ctx):
    calls = calls_started(ctx)
    return sum(c[1] - c[0] for c in calls) * 1e3 / len(calls) if calls else None
