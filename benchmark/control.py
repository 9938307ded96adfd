"""Readings for the limits of the comparison that decides ``correct``.

    python3 -m benchmark.control --workload <name> --system program \\
        --seeds 1 2 3 ... --seconds 2
    python3 -m benchmark.control --workload <name> --system control \\
        --seeds 1 2 3 --seconds 2      # or control_rays

runs the cell once a seed in one process (its ranks in as many), at the
cell's own size and load for ``--seconds``, with the program (the lower
readings), with the lower-precision control in its place
(``systems.Control``: the reference in bfloat16; ``ControlRays``: in
float32 with bfloat16 camera rays; the upper readings), or with a fault
of ``faults.py`` planted (``--fault``; a training cell's upper
readings), and prints one JSON line a seed: the numbers compared, each
beside the limit the configuration gives it. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=("program", "control",
                                         "control_rays"),
                    required=True)
    ap.add_argument("--fault", choices=("none", "unchanged", "half_batch",
                                        "altered"), default="none",
                    help="with --system program: plant a fault of "
                         "faults.py in the timed path")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import compare, drive, faults, spec
    from benchmark.systems import SYSTEMS

    system_cls = (faults.FAULTS[args.fault] if args.fault != "none"
                  else SYSTEMS[args.system])
    cell = spec.cell(spec.load_benchmark(), args.workload)
    world = cell["traffic"].get("ranks", 1)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark.control: {args.workload} needs {cell['chips']} "
              "CUDA device(s)", file=sys.stderr)
        return 2
    port = args.port
    procs, stop = [], None
    if args.rank == 0:
        port = run.free_port() if port is None else port
        if world > 1:
            procs, stop = run.start_ranks(
                "benchmark.control",
                ["--workload", args.workload, "--system", args.system,
                 "--fault", args.fault, "--seconds", str(args.seconds),
                 "--seeds",
                 *map(str, args.seeds)], world, port)
    ok = True
    try:
        for i, seed in enumerate(args.seeds):
            rec = drive.run(cell, seed, args.seconds, False,
                            system_cls, f"cuda:{args.rank}",
                            time.perf_counter(), rank=args.rank, world=world,
                            port=port + i)
            if rec is not None:
                print(json.dumps({"workload": args.workload,
                                  "system": args.system,
                                  "fault": args.fault, "seed": seed,
                                  "correct": compare.is_correct(
                                      rec["checks"]),
                                  "items": rec["items"],
                                  "reference_s": rec["reference_s"],
                                  "checks": rec["checks"]}), flush=True)
    finally:
        if stop is not None:
            ok = run.join_ranks(procs, stop)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
