"""The comparison that decides ``correct`` fails what it must: the
lower-precision control in the program's place, and each fault a cell
can have planted in the timed path, on a whole run past the harness's
look for a chip (the CPU, a tiny size). The sound program passes."""

import multiprocessing

import pytest
import torch

from benchmark import faults, run
from benchmark.systems import Control, ControlRays
from benchmark.tests.helpers import run_tiny

SEEDS = [1, 2_147_483_659]


@pytest.mark.parametrize("workload", ["portal.train", "portal.render"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_program_is_correct(workload, seed):
    assert run_tiny(workload, seed)["correct"]


@pytest.mark.parametrize("workload", ["portal.train", "portal.render"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("control", [Control, ControlRays],
                         ids=["bfloat16", "bfloat16_rays"])
def test_control_is_not_correct(workload, seed, control):
    """The reference in bfloat16, and in float32 with bfloat16 camera
    rays."""
    assert not run_tiny(workload, seed, system=control)["correct"]


FAULTS = [("portal.train", "unchanged"), ("portal.train", "half_batch"),
          ("portal.train", "altered"), ("portal.render", "half_batch"),
          ("portal.render", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    out = run_tiny(workload, SEEDS[0], system=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


class _NoExchange:
    """torch.distributed as the program sees it, with the film merge's
    and the gradients' exchange between ranks left out."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, tensor, *a, **k):
        return None

    def all_gather(self, parts, tensor, *a, **k):
        for p in parts:
            p.copy_(tensor)


def _rank(rank, world, port, fault, q):
    torch.set_num_threads(1)
    if fault:
        from pbrt_tpu_torch.parallel import render as par

        par.dist = _NoExchange(par.dist)
    out = run_tiny("portal.train.4chip", SEEDS[0], rank=rank, world=world,
                   port=port)
    if rank == 0:
        q.put(out)


@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "exchange_left_out"])
def test_sharded_step(fault):
    ctx = multiprocessing.get_context("spawn")
    q, port = ctx.Queue(), run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, 4, port, fault, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        out = q.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert out["correct"] is (not fault), out["checks"]
