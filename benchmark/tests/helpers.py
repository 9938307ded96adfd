"""Drive one cell on the CPU at a tiny size, past the harness's look for
a chip: the driver, the comparison and the result line, with the
program's plain twins."""

import json
import time

from benchmark import drive, run, spec
from benchmark.systems import Program

TINY = {"width": 32, "height": 32, "spp": 4}


def tiny_cell(workload):
    cell = spec.cell(spec.load_benchmark(), workload)
    cell["traffic"].update(TINY)
    if "chunk_spp" in cell["traffic"]:
        cell["traffic"]["chunk_spp"] = 2
    return cell


def run_tiny(workload, seed, system=Program, seconds=0.5, rank=0, world=1,
             port=None):
    """The result line of one run (rank 0; None on the other ranks)."""
    cell = tiny_cell(workload)
    rec = drive.run(cell, seed, seconds, False, system, "cpu",
                    time.perf_counter(), rank=rank, world=world,
                    port=port if port is not None else run.free_port())
    if rec is None:
        return None
    out = run.result(cell, rec, False, cell["chips"], "cpu")
    return json.loads(json.dumps(out))
