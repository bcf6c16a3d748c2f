"""The device trace of a window (``--trace 1``).

``torch.profiler`` records CUDA activity only (kernels, copies, sets): a host
trace of the ~30k aten ops of each verify call would cost tens of seconds to
reduce. The reduction keeps the device operations that overlap the window,
clipped to it, and gives:

* ``busy_s``: the length of the union of their intervals;
* ``device_ops``: seconds by operation name, the largest first;
* ``idle_gaps``: the longest stretches with nothing on the device, each
  named by what the host was doing then, read from the benchmark's own
  spans (a verify call's host half, its device stages, a prepare call, or
  nothing of these).

The profiler's clock is matched to ``time.monotonic()`` at run time: its
timestamps are on the wall clock or the monotonic one, and the two differ by
decades.
"""

from __future__ import annotations

import time


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.events: list = []     # (name, start, end) in monotonic seconds, clipped
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self, t0: float, t1: float) -> None:
        """Stop the profiler and keep the device operations in [t0, t1]."""
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        self.t0, self.t1 = t0, t1
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if "cuda" not in str(e.device_type()).lower():
                continue
            dur = e.duration_ns()
            if dur <= 0:
                continue
            raw.append((e.name(), e.start_ns(), dur))
        self._prof = None
        if not raw:
            return
        mono, wall = time.monotonic_ns(), time.time_ns()
        first = min(s for _, s, _ in raw)
        # events on the wall clock sit ~wall - mono away from the monotonic one
        shift = (mono - wall) if abs(first - wall) < abs(first - mono) else 0
        for name, s, dur in raw:
            a = (s + shift) / 1e9
            b = a + dur / 1e9
            a, b = max(a, t0), min(b, t1)
            if b > a:
                self.events.append((name, a, b))
        self.events.sort(key=lambda x: x[1])

    def busy_intervals(self) -> list:
        out = []
        for _, a, b in self.events:
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1][1] = b
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for name, a, b in self.events:
            short = name.replace("(anonymous namespace)::", "").split("(")[0].strip()[:96]
            by[short] = by.get(short, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, spans: dict, top: int = 10) -> list:
        """The ``top`` longest device-idle gaps in the window, each named by
        the host span (``spans``: label -> [(start, end)]) that covers its
        midpoint, and its offset into the window."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            label = "no benchmark span (engine waiting)"
            for name, ivs in spans.items():
                if any(s <= mid <= e for s, e in ivs):
                    label = name
                    break
            out.append([f"{label} @{a - self.t0:.3f}s", b - a])
        return out
