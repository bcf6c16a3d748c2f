"""att.batch_fill: payloads per verify call, over the calls that started in
the window (bisection calls included: each is a call the device pays for)."""

from benchmark.harness.readings import calls_started


def read(ctx):
    calls = calls_started(ctx)
    return sum(c[4] for c in calls) / len(calls) if calls else None
