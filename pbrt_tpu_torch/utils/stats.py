"""Counters and phase timers (port of the host part of
pbrt_tpu/utils/stats.py, core/stats.{h,cpp}): named host counters and
wall-clock phases, printed by ``print_stats`` as pbrt's PrintStats does.
Device time is not sampled here; the CLI times its render with CUDA
events."""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict

_COUNTERS: dict = defaultdict(float)
_PHASE_TIMES: dict = defaultdict(float)


def counter_add(name: str, value=1):
    """STAT_COUNTER accumulation."""
    _COUNTERS[name] += float(value)


@contextlib.contextmanager
def profile_phase(name: str):
    """ProfilePhase (stats.h:142-195): wall time per phase; nests."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASE_TIMES[name] += time.perf_counter() - t0


def phase_times() -> dict:
    """Seconds spent in each phase so far."""
    return dict(_PHASE_TIMES)


def print_stats(file=None):
    """PrintStats (stats.cpp)."""
    f = file or sys.stderr
    if _COUNTERS:
        print("Statistics:", file=f)
        for k in sorted(_COUNTERS):
            print(f"    {k:<50} {_COUNTERS[k]:,.0f}", file=f)
    if _PHASE_TIMES:
        total = sum(_PHASE_TIMES.values())
        print("  Profile (wall time):", file=f)
        for k, t in sorted(_PHASE_TIMES.items(), key=lambda kv: -kv[1]):
            print(f"    {k:<50} {t:8.2f}s ({100 * t / total:4.1f}%)",
                  file=f)
