"""Host health snapshot (Lighthouse's common/system_health): process and
system stats for the /health surface and the monitoring push, with the
port's fault domains (``resilience.health_snapshot``). The port's copy of
``lighthouse_tpu/utils/system_health.py``."""

from __future__ import annotations

import os
import shutil


def system_health(datadir: str | None = None) -> dict:
    out: dict = {"pid": os.getpid()}
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        out["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        pass
    try:
        load1, load5, load15 = os.getloadavg()
        out["loadavg"] = [round(load1, 2), round(load5, 2), round(load15, 2)]
    except OSError:
        pass
    out["cpu_count"] = os.cpu_count()
    try:
        usage = shutil.disk_usage(datadir or "/")
        out["disk_total_bytes"] = usage.total
        out["disk_free_bytes"] = usage.free
    except OSError:
        pass
    # fault-domain health (resilience.supervisor): backend states, recent
    # classified faults — degradation must be visible from /health
    try:
        from ..resilience import health_snapshot

        out["fault_domains"] = health_snapshot()
    except Exception:  # noqa: BLE001 — health must never fail the probe
        pass
    return out
