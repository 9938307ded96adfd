"""Run one cell of the benchmark of pbrt_tpu_torch and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, benchmark/ and
pbrt_tpu_torch/. The cell's chips must be there (``torch.cuda``); a cell
of several ranks starts one process a card on a free localhost port, this
process being rank 0. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; standard error ends with the same
numbers. Exits non-zero, printing no result, without the chips, when a
rank fails, or when a module of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

_T_IMPORT = time.perf_counter()


def process_start() -> float:
    """perf_counter() at this process's start (Linux; else at import)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    return ap.parse_args(argv)


def start_ranks(module, argv, world, port):
    """Start ranks 1 … world − 1 as processes of ``module`` with this
    process's ``argv``, and a thread that ends this process (rank 0, which
    would wait for a failed rank forever) when one fails. Returns the
    processes and the thread's stop event."""
    cmd = [sys.executable, "-m", module, *argv, "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.DEVNULL)
             for r in range(1, world)]
    stop = threading.Event()

    def watch():
        while not stop.wait(1.0):
            if any(p.poll() not in (None, 0) for p in procs):
                print("benchmark: a rank failed", file=sys.stderr,
                      flush=True)
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    return procs, stop


def join_ranks(procs, stop) -> bool:
    """Wait for the ranks; True when every one ended well."""
    stop.set()
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return all(p.returncode == 0 for p in procs)


def result(cell, rec, do_trace, chips, kind_name):
    from benchmark import compare, guard, spec

    listed = cell["per_layer"] if do_trace else cell["end_to_end"]
    metrics = {}
    for m in listed:
        v = spec.reader(m["name"], cell.get("root", spec.ROOT))(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind_name, "count": chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if do_trace and rec.get("busy_s") is not None:
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["trace_window_s"]
    out = {"correct": compare.is_correct(rec["checks"]),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if do_trace and rec.get("breakdown"):
        out["breakdown"] = rec["breakdown"]
    out["checks"] = rec["checks"]
    bad = guard.forbidden()
    if bad:
        raise SystemExit(f"benchmark: the process loaded {bad}: the JAX "
                         "package is not measured")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    t_process = process_start()
    os.environ["USE_FLAX"] = "0"
    import torch

    from benchmark import compare, drive, spec
    from benchmark.systems import Program

    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    cell = spec.cell(spec.load_benchmark(), args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    world = cell["traffic"].get("ranks", 1)
    if world != chips:
        raise ValueError(f"{args.workload}: {world} ranks on {chips} chips")
    port = args.port
    procs, stop = [], threading.Event()
    if args.rank == 0:
        port = free_port() if port is None else port
        procs, stop = start_ranks(
            "benchmark.run", ["--workload", args.workload, "--seed",
                              str(args.seed), "--seconds", str(args.seconds),
                              "--trace", str(args.trace)], world, port)
    try:
        rec = drive.run(cell, args.seed, args.seconds, bool(args.trace),
                        Program, f"cuda:{args.rank}", t_process,
                        rank=args.rank, world=world, port=port)
    finally:
        ranks_ok = join_ranks(procs, stop)
    if args.rank != 0:
        return 0
    if not ranks_ok:
        print("benchmark: a rank failed", file=sys.stderr)
        return 1
    out = result(cell, rec, bool(args.trace), chips,
                 torch.cuda.get_device_name(0))
    print(f"benchmark: {args.workload} setup_s {rec['setup_s']!r} window_s "
          f"{rec['window_s']!r} items {rec['items']} reference_s "
          f"{rec['reference_s']!r}", file=sys.stderr)
    compare.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
