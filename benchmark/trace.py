"""Device traces: a torch.profiler capture of a block of the window, and
the reductions the per-layer readers share.

A capture covers one block of iterations between two synchronisations
of the card; its Chrome trace is read back into memory and deleted. A
device capture records the card's activity alone (kernels, copies, sets
and the CUDA API calls that launched them), so the profiler adds little
host time to the block; its span runs from the end of the first
synchronisation to the end of the last. A host capture also records
every host op, inside an annotation named ``SPAN``, for readers that
attribute kernels to the host ops that launched them; its host time is
several times the unprofiled one. Every time is in the trace's
microseconds until a reader converts it.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

SPAN = "bench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def capture(run_block, device, host_ops=False) -> list[dict]:
    """The trace events of ``run_block()``, run between two
    synchronisations of ``device``; with ``host_ops`` the host's ops too,
    inside the ``SPAN`` annotation."""
    acts = []
    if host_ops or device.type != "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.profiler.profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function(SPAN):
            run_block()
            sync()
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def span(events):
    """(start, end) of the block: its annotation in a host capture, else
    from the end of the first synchronisation to the end of the last."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == SPAN:
            return e["ts"], e["ts"] + e["dur"]
    syncs = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("cat") in LAUNCH_CATS
                   and "Synchronize" in e["name"])
    if len(syncs) >= 2:
        return syncs[0], syncs[-1]
    dev = device_events(events)
    if not dev:
        raise ValueError("the trace holds no device activity")
    return (min(e["ts"] for e in dev), max(e["ts"] + e["dur"] for e in dev))


def device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def kernels(events):
    return [e for e in events if e.get("cat") == "kernel"]


def count(events, substring: str) -> int:
    """Kernel records whose name holds ``substring``."""
    return sum(substring in e["name"] for e in kernels(events))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(events):
    """(busy, window) in microseconds: the union of the device's
    kernel, copy and set intervals inside the span, and the span."""
    s0, s1 = span(events)
    iv = [(max(e["ts"], s0), min(e["ts"] + e["dur"], s1))
          for e in device_events(events)]
    u = _union([(a, b) for a, b in iv if b > a])
    return sum(b - a for a, b in u), s1 - s0


def idle_pct(events):
    b, w = busy(events)
    return 100.0 * (1.0 - b / w)


def kernel_us(events, pred) -> float:
    """Summed duration of the kernels whose name satisfies ``pred``."""
    return sum(e["dur"] for e in kernels(events) if pred(e["name"]))


def device_us_under(events, prefix: str) -> float:
    """Device time of the kernels, copies and sets launched from inside a
    host op whose name starts with ``prefix`` (on the launching thread)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith(prefix):
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    merged = {t: _union(v) for t, v in by_tid.items()}
    starts = {t: [a for a, _ in v] for t, v in merged.items()}
    corr = set()
    for e in events:
        if e.get("cat") not in LAUNCH_CATS or e["tid"] not in merged:
            continue
        iv, st = merged[e["tid"]], starts[e["tid"]]
        i = bisect.bisect_right(st, e["ts"]) - 1
        if i >= 0 and e["ts"] <= iv[i][1]:
            corr.add(e.get("args", {}).get("correlation"))
    return sum(e["dur"] for e in device_events(events)
               if e.get("args", {}).get("correlation") in corr)


def breakdown(events, top=10):
    """The device operations that took most time, and the longest idle
    gaps inside the span named by the innermost host op running at each
    gap's middle: {"device_ops": [[name, s]], "idle_gaps": [[name, s]]}."""
    tot = collections.Counter()
    for e in device_events(events):
        tot[e["name"]] += e["dur"] * 1e-6
    s0, s1 = span(events)
    u = _union([(max(e["ts"], s0), min(e["ts"] + e["dur"], s1))
                for e in device_events(events)
                if min(e["ts"] + e["dur"], s1) > max(e["ts"], s0)])
    edges = [s0] + [x for iv in u for x in iv] + [s1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in ("cpu_op", "python_function",
                                                   "user_annotation")
            + LAUNCH_CATS and e.get("name") != SPAN]
    # in a device capture the host's ops are not recorded: a gap outside
    # every CUDA call is the host's Python and torch dispatch
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = (min(inside, key=lambda e: e["dur"])["name"] if inside
                else "host: no CUDA call")
        named.append([name, (b - a) * 1e-6])
    return {"device_ops": [[k, v] for k, v in tot.most_common(top)],
            "idle_gaps": named}
