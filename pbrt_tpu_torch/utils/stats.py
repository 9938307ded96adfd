"""Counters, distributions, phase timers and a device trace (port of
pbrt_tpu/utils/stats.py, core/stats.{h,cpp}): named host counters, the
STAT_*_DISTRIBUTION analogue (``report_value``) and wall-clock phases,
printed by ``print_stats`` as pbrt's PrintStats does; ``device_trace``
takes pbrt_tpu's ``jax_trace`` place with a torch.profiler trace. The CLI
times its render with CUDA events."""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

_COUNTERS: dict = defaultdict(float)
_DISTRIBUTIONS: dict = defaultdict(list)
_PHASE_TIMES: dict = defaultdict(float)


def counter_add(name: str, value=1):
    """STAT_COUNTER accumulation."""
    _COUNTERS[name] += float(value)


def report_value(name: str, value):
    """STAT_INT_DISTRIBUTION / STAT_FLOAT_DISTRIBUTION: one value of a
    distribution (a number or a one-element tensor; a tensor on the card
    is read, so report values outside the hot loop)."""
    _DISTRIBUTIONS[name].append(float(value))


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the block (pbrt_tpu's ``jax_trace``, the
    sampling profiler's successor): CPU activities, and the card's where
    there is one. On exit it writes a Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir`` and sets the yielded profiler's
    ``trace_path`` to it. The profiler may drop kernel records of a long
    trace, so count launches elsewhere."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    fd, prof.trace_path = tempfile.mkstemp(prefix="trace_", suffix=".json",
                                           dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(prof.trace_path)


def print_stats(file=None):
    """PrintStats (stats.cpp): counters, distributions (avg, min, max),
    then the phases by wall time."""
    f = file or sys.stderr
    if _COUNTERS:
        print("Statistics:", file=f)
        for k in sorted(_COUNTERS):
            print(f"    {k:<50} {_COUNTERS[k]:,.0f}", file=f)
    for k in sorted(_DISTRIBUTIONS):
        v = np.asarray(_DISTRIBUTIONS[k])
        print(f"    {k:<50} avg {v.mean():.3f} "
              f"(min {v.min():.3f}, max {v.max():.3f})", file=f)
    if _PHASE_TIMES:
        total = sum(_PHASE_TIMES.values())
        print("  Profile (wall time):", file=f)
        for k, t in sorted(_PHASE_TIMES.items(), key=lambda kv: -kv[1]):
            print(f"    {k:<50} {t:8.2f}s ({100 * t / total:4.1f}%)",
                  file=f)


def clear_stats():
    """Forget every counter, distribution and phase."""
    _COUNTERS.clear()
    _DISTRIBUTIONS.clear()
    _PHASE_TIMES.clear()
