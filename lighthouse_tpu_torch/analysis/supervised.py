"""Pass 4 — the supervisor-transparency probe.

The port of ``lighthouse_tpu/analysis/supervised.py``. The fault-domain
supervisor (``resilience.supervisor``) wraps the device calls of the
serving path; the wrapper must be *invisible*: it passes arguments through
untouched, so it may add no steady-state build and return the kernel's
result bit for bit. The port adds a third property the reference has no
counterpart for: the watchdog runs the call on its own thread, the current
CUDA device is per thread, and the kernels' ctypes launches take the
current device's context — so inside the call the current device must be
the operands' (``resilience.supervisor._on_caller_device``).

``supervisor_probe`` checks, cheaply enough for the CLI:

1. the ``resilience`` package lints clean under the host-sync rules;
2. a kernel call through ``run_ladder`` adds zero builds after warm-up
   (``recompile.steady_state_builds``) and returns the bare call's result
   bit for bit;
3. inside the call, ``torch.cuda.current_device()`` equals the operand's
   device index (on a card).
"""

from __future__ import annotations

import os


def supervisor_probe(device="cuda", steps: int = 4, call=None, supervisor=None) -> dict:
    """Run the three checks; returns a report dict with ``ok``.

    ``call`` is a zero-argument function returning the kernel's result
    (default: one ``fq.mont_mul`` on ``device``); ``supervisor`` the one to
    go through (default: a private one, kept out of the global registry so
    it never shows in /health)."""
    import torch

    from ..ops.bls import fq
    from ..resilience.supervisor import BackendSupervisor, SupervisorConfig
    from .hygiene import lint_tree
    from .recompile import steady_state_builds

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings, _suppressed = lint_tree(root=pkg, scope=("resilience",))

    if call is None:
        x = torch.arange(4 * fq.NLIMBS, dtype=torch.int64, device=dev).reshape(4, fq.NLIMBS)

        def call():
            return fq.mont_mul(x, x)

    devices_seen: list = []

    def thunk():
        if dev.type == "cuda":
            devices_seen.append(torch.cuda.current_device())
        return call()

    def result(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                torch.cuda.synchronize(v.device)
            return v.cpu()
        return v

    bare = result(call())
    sup = supervisor or BackendSupervisor(
        "analysis.supervisor_probe", SupervisorConfig(deadline_s=60.0)
    )

    def step():
        return result(sup.run_ladder("analysis.probe", (("device_full", thunk),)))

    builds = steady_state_builds(step, warmup=2, steps=steps)
    supervised = step()
    if isinstance(bare, torch.Tensor):
        transparent = bool(torch.equal(supervised, bare))  # lint: allow(host-sync) CPU tensors
    else:
        transparent = supervised == bare
    right_device = all(d == dev.index for d in devices_seen) if dev.type == "cuda" else True
    return {
        "ok": not findings and not builds and transparent and right_device,
        "device": str(dev),
        "lint_findings": [f.as_dict() for f in findings],
        "steady_state_builds": builds,
        "transparent": transparent,
        "current_devices": sorted(set(devices_seen)),
        "right_device": right_device,
        "supervised_calls": sup.calls,
    }
