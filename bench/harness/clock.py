"""The process's start on the ``time.perf_counter`` clock, so that
``setup_s`` runs from the process's start (loading Python and torch
included) to the start of the window."""
from __future__ import annotations

import os
import time

_START = None


def _age_s() -> float:
    """Seconds since the process started, from /proc: the uptime now less
    field 22 of /proc/self/stat (the start, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


def mark_process_start() -> None:
    global _START
    try:
        age = _age_s()
    except (OSError, ValueError, IndexError):
        age = 0.0
    _START = time.perf_counter() - age


def process_start() -> float:
    """The process's start on the perf_counter clock (now, if unmarked)."""
    if _START is None:
        mark_process_start()
    return _START
