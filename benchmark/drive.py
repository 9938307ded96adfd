"""What every kind of traffic shares: the inputs a run draws from its
seed, the count of samples through ``render``'s progress argument, the
traced block's retries, the reference of the cell's configuration, and
``run``, which hands a cell to the driver of its traffic's ``kind``
(``benchmark/kinds/<kind>.py``, found by name).

Every seed gives the same sizes; the seed picks only the sample streams,
the parameters' perturbation and which items are compared. With
``trace`` set, a kind runs a block of its window under the profiler,
again (up to ``TRIES`` times) while a kernel the block is known to
launch is missing from its trace.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import spec, trace

M32 = 0xFFFFFFFF
TRIES = 3


class Inputs:
    """Everything a run draws from its seed."""

    def __init__(self, seed: int, perturb: float = 0.0):
        g = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence(int(seed) & (2 ** 64 - 1))))
        self.base = int(g.integers(0, 2 ** 32))
        self.target_seed = int(g.integers(0, 2 ** 32))
        self.warm_seed = int(g.integers(0, 2 ** 32))
        self.f_kd = 1.0 + perturb * (g.random((64, 3)) - 0.5)
        self.f_emit = 1.0 + perturb * (g.random(3) - 0.5)
        self.pick = random.Random(int(g.integers(0, 2 ** 63)))

    def seed(self, k: int) -> int:
        return (self.base + k) & M32


class Progress:
    """``render``'s progress argument: counts the samples of the passes
    it reports."""

    def __init__(self, pixels: int):
        self.pixels = pixels
        self.samples = 0

    def update(self, n: int = 1):
        self.samples += n * self.pixels

    def finish(self):
        pass


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def want(cell, iters, passes_per_iter):
    """Kernel name → the least count the block's trace must hold."""
    out = {k: iters * passes_per_iter
           for k in cell["config"].get("pass_kernels", [])}
    for k in cell["traffic"].get("step_kernels", []):
        out[k] = max(out.get(k, 0), iters)
    return out


def complete(events, wanted) -> bool:
    return all(trace.count(events, k) >= n for k, n in wanted.items())


def reference(cell, device, dtype=torch.float64):
    """The plain reference module of the cell's configuration and its
    scene, worked out again from the scene file with the configuration's
    settings (the same the program is given)."""
    config = cell["config"]
    ref = spec.reference(config["reference"])
    root = cell.get("root", spec.ROOT)
    sc = ref.load(str(root / config["scene"]), config, device, dtype)
    return ref, sc


def trace_fields(rec, events, iters):
    rec["events"] = events or None
    rec["trace_iters"] = iters
    if events:
        b, w = trace.busy(events)
        rec["busy_s"], rec["trace_window_s"] = b * 1e-6, w * 1e-6
        rec["breakdown"] = trace.breakdown(events)


def run(cell, seed, seconds, do_trace, system_cls, device, t_process,
        rank=0, world=1, port=None):
    """One run of ``cell`` by the driver of its traffic's kind. Returns
    the record the metric readers read (rank 0), or None (the other
    ranks)."""
    kind = spec.kind(cell["traffic"]["kind"], cell.get("root", spec.ROOT))
    rec = kind.run(cell, seed, seconds, do_trace, system_cls,
                   torch.device(device), t_process, rank, world, port)
    if rec is not None:
        rec["config"] = cell["config"]
    return rec
