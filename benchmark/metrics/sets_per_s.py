"""sets_per_s: signature sets whose payload's verdict was delivered inside
the window, over the window's seconds (closed loop: the intake never runs
dry, so this is what the node can verify before it must shed)."""

from benchmark.harness.readings import sets_answered


def read(ctx):
    return sets_answered(ctx) / ctx.window.seconds
