"""Time the sharded render and the training step over N ranks, one
device each, against the single-process render on rank 0.

    python -m pbrt_tpu_torch.tools.sharded_times --ranks 4
    python -m pbrt_tpu_torch.tools.sharded_times --ranks 4 --cpu \\
        --res 16 --spp 8                      # gloo, the plain twins

The launcher starts N processes of this module on one host (rank r on
card r under NCCL, or on the CPU under gloo with ``--cpu``), each calling
``parallel.initialize_multihost`` on a free localhost port. Every rank
renders the main path's scene (``entry._portal_scene``, ``path``,
max_depth 4) at ``--res``² × ``--spp`` through ``render_sharded`` over
``make_mesh(N)`` and takes ``--steps`` SGD steps on kd and emit against a
black target (lr 1). Rank 0 then renders the same image with ``render()``
and takes the first step's gradients by single-process autograd, and
prints one JSON line: the card, the mesh, ``render_sharded``'s ms (CUDA
events, mean of three after a warm-up; the host clock on the CPU), each
step's ms (host clock between synchronisations), the largest differences
from the single-process image and gradients (held to
tests/test_parallel.py's rtol 2e-3 / atol 3e-4 and rtol 2e-3 / atol
1e-6), the single-process render's and fwd+bwd's ms, and the losses.
Exits non-zero when a rank fails or a check does not hold.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ms(fn, dev, reps=3):
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def rank_main(args):
    import torch.distributed as dist

    from pbrt_tpu_torch import entry
    from pbrt_tpu_torch.integrators import render as render_mod
    from pbrt_tpu_torch.parallel import (initialize_multihost,
                                         inverse_render_step, make_mesh,
                                         render_sharded)
    from pbrt_tpu_torch.parallel.render import _set_params

    device = "cpu" if args.cpu else "cuda"
    initialize_multihost(f"localhost:{args.port}", args.ranks, args.rank,
                         device)
    mesh = make_mesh(args.ranks)
    dev = mesh.device
    scene = entry._portal_scene(dev)
    cam = entry._camera((args.res, args.res), dev)
    kw = dict(spp=args.spp, max_depth=4)

    img = render_sharded(scene, cam, mesh, **kw)
    shard_ms = _ms(lambda: render_sharded(scene, cam, mesh, **kw), dev)
    target = torch.zeros_like(img)
    params = {"kd": scene.materials.kd, "emit": scene.lights.emit}
    p, losses, step_ms = params, [], []
    for k in range(args.steps):
        _sync(dev)
        t0 = time.perf_counter()
        new, loss = inverse_render_step(scene, cam, mesh, target, p, lr=1.0,
                                        **kw)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if k == 0:
            g_step = {n: p[n] - new[n] for n in p}
        losses.append(float(loss))
        p = new
    out = None
    if args.rank == 0:
        ref = render_mod.render(scene, cam, device=dev, **kw)
        render_ms = _ms(lambda: render_mod.render(scene, cam, device=dev,
                                                  **kw), dev, reps=1)
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        _sync(dev)
        t0 = time.perf_counter()
        img1 = render_mod.render(_set_params(scene, leaves), cam,
                                 device=dev, **kw)
        torch.mean((img1 - target) ** 2).backward()
        _sync(dev)
        grad_ms = 1e3 * (time.perf_counter() - t0)
        torch.testing.assert_close(img, ref, rtol=2e-3, atol=3e-4)
        for n in params:
            torch.testing.assert_close(g_step[n], leaves[n].grad,
                                       rtol=2e-3, atol=1e-6)
        card = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                else "cpu")
        out = {"card": card, "backend": dist.get_backend(),
               "ranks": args.ranks, "mesh": mesh.shape, "res": args.res,
               "spp": args.spp, "render_sharded_ms": shard_ms,
               "step_ms": step_ms, "losses": losses,
               "image_max_abs_err": float((img - ref).abs().max()),
               "grad_max_abs_err": {n: float((g_step[n] - leaves[n].grad)
                                             .abs().max()) for n in params},
               "single_render_ms": render_ms,
               "single_fwd_bwd_ms": grad_ms}
    dist.barrier()
    dist.destroy_process_group()
    if out is not None:
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise RuntimeError(f"the loss does not fall: {losses}")
        print(json.dumps(out))


def launch(args):
    """Start the ranks, wait for them all, pass rank 0's line on."""
    from pbrt_tpu_torch.entry import _free_port

    port = str(_free_port())
    cmd = [sys.executable, "-m", "pbrt_tpu_torch.tools.sharded_times",
           "--ranks", str(args.ranks), "--port", port, "--res",
           str(args.res), "--spp", str(args.spp), "--steps",
           str(args.steps)] + ["--cpu"] * args.cpu
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE, text=True)
             for r in range(args.ranks)]
    try:
        outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rc = max(p.returncode for p in procs)
    sys.stdout.write(outs[0])
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sharded_times")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        return launch(args)
    if args.cpu:
        torch.set_num_threads(1)
    rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
