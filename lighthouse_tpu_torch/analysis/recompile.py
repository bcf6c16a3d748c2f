"""Pass 3 — the build sentinel: prove steady-state loops stay warm.

The port of ``lighthouse_tpu/analysis/recompile.py``. The reference counts
XLA compilations; the port compiles nothing at run time (the kernels are
built once per process by nvcc, and eager torch traces nothing), so the
sentinel counts what a steady serving loop must not redo once warm:

* new ``fused_mul.SCHEDULES`` entries and ``_PLAN_CACHE`` misses (a plan
  signature derived again: its bound walk and table encoding, ~ms of host
  time each);
* uploads of a schedule's or a chain program's tables to a device
  (``Schedule.device_desc``, ``ChainProgram.device_args``) and of
  ``fq.dconst`` constants;
* misses of the cached builders (``fq.certified_cache``: the reduction
  plans, the fixed-exponent and tower chain programs, the chain compiler,
  the multiply schedules);
* loads and nvcc builds of the kernels' library (``fused_mul._lib``,
  ``fused_mul.build``).

The counters live in ``fq.builds`` (fused_mul's among them), bumped where
the work happens. Usage::

    sentinel = BuildSentinel()
    warmup()
    mark = sentinel.snapshot()
    steady_step()
    assert sentinel.builds_since(mark) == []     # names of what was rebuilt

or ``steady_state_builds(step_fn, warmup=2, steps=3)``. The counters are
process-wide (the caches are), so concurrent loops share them.
"""

from __future__ import annotations

__all__ = ["BuildSentinel", "steady_state_builds", "recompile_probe"]


def build_counts() -> dict:
    """{counter: count}: the build counters of fq and fused_mul."""
    from ..ops.bls import fq, fused_mul  # noqa: F401  (fused_mul registers its counters)

    with fq._BUILDS_LOCK:
        return dict(fq.builds)


class BuildSentinel:
    """Marks of the build counters; ``builds_since(mark)`` lists what was
    built after the mark (one name per build)."""

    def snapshot(self) -> dict:
        """Mark the current counts (call after warm-up)."""
        return build_counts()

    def builds_since(self, mark: dict) -> list[str]:
        """Names of the builds since ``mark``, one entry per build — empty
        means the loop is steady-state clean."""
        out = []
        for name, n in sorted(build_counts().items()):
            out += [name] * (n - mark.get(name, 0))
        return out


def steady_state_builds(step_fn, warmup: int = 2, steps: int = 3) -> list[str]:
    """Run ``step_fn()`` ``warmup`` times, then ``steps`` more under the
    sentinel; return what the steady phase built (empty = nothing)."""
    sentinel = BuildSentinel()
    for _ in range(warmup):
        step_fn()
    mark = sentinel.snapshot()
    for _ in range(steps):
        step_fn()
    return sentinel.builds_since(mark)


def recompile_probe(device="cuda", steps: int = 4) -> dict:
    """The CLI's runtime check: a warm loop of the plan kernel's wrapper
    (one ``fq.mont_mul`` on ``device``, a launch on a card, the plain
    version on the CPU) builds nothing after warm-up; and a step that
    derives a new plan signature is seen (so the counters are live)."""
    import torch

    from ..ops.bls import fq, plans

    dev = torch.device(device)
    x = torch.zeros((4, fq.NLIMBS), dtype=torch.int64, device=dev)
    x[:, 0] = 3

    def step():
        fq.mont_mul(x, x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    names = steady_state_builds(step, warmup=2, steps=steps)
    sentinel = BuildSentinel()
    mark = sentinel.snapshot()
    plan = plans.Plan(1, 1)
    lane = plan.lane(plans.LC.basis(0), plans.LC.basis(0))
    plan.out_rows = [lane]
    plans.execute(plan, x[:, None], x[:, None], name="analysis_probe")
    seen = sentinel.builds_since(mark)
    return {
        "ok": names == [] and "plan_miss" in seen,
        "device": str(dev),
        "steady_state_builds": names,
        "fresh_plan_builds": seen,
    }
