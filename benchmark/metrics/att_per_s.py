"""att_per_s: payloads whose verdict was delivered inside the window, over
the window's seconds (open loop: below the knee this is the offered rate less
the payloads still owed at the window's end, so it falls as their latency
grows, and falls away once the load passes what the node sustains)."""


def read(ctx):
    w = ctx.window
    return sum(1 for s in w.subs if s.done is not None and w.t0 <= s.done <= w.t_end) / w.seconds
