"""Time the render path's fused and brute-force kernels at the main path's
shapes, through their public wrappers only, so that the same script times
another checkout of the port (an earlier commit) on the same card:

    python pbrt_tpu_torch/tools/kernel_times.py                # this one
    PYTHONPATH=<other checkout> python pbrt_tpu_torch/tools/kernel_times.py

(run as a file, the script imports ``pbrt_tpu_torch`` from PYTHONPATH
first). Shapes: the fused kernel on ``_portal_scene`` (2,097,152 lanes,
max_depth 4); the brute-force kernel on 2,097,152 camera rays against the
portal-strategy portal, ``_sphere_cornell`` and a 4,001-primitive table,
and at the call shape a BVH scene gives it (``_heightfield_cornell()``'s
sphere and aaplane, tmax from the traversal, camera rays). Prints one JSON
line: the package's path, the card and the mean ms of each launch by CUDA
events. Needs a CUDA device.
"""

import json
import math
import subprocess
import sys

import torch

import pbrt_tpu_torch
from pbrt_tpu_torch import entry
from pbrt_tpu_torch.integrators import render as render_mod
from pbrt_tpu_torch.ops import bvh as bk
from pbrt_tpu_torch.ops import fused_path as fp
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene.types import SceneBuilder

RES, SPP, MAX_DEPTH, REPS = 256, 32, 4, 20


def cap_table(dev):
    """The portal box, a 3,776-triangle tessellated sphere, 200 small
    spheres and the light's aaplane: 4,001 primitives, no BVH."""
    b = SceneBuilder()
    white, black = entry._box_with_opening(b)
    entry._add_sphere_mesh(b, (0.35, 0.22, 0.45), 0.22, white, 44)
    for i in range(200):
        b.add_sphere((0.55 + 0.04 * (i % 10), 0.03 + 0.045 * (i // 10), 0.8),
                     0.02, mat=white)
    entry._portal_light(b, black, "portal")
    return b.build(dev, use_bvh="never")


def ms_of(fn, reps=REPS):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH)
    rays, pid, sidx, _ = render_mod.camera_rays(
        entry._camera((RES, RES), dev), film_mod.make_filter("box",
                                                             device=dev),
        cfg, RES, RES, SPP, 0, dev)
    o, d = rays.o.contiguous(), rays.d.contiguous()
    out = {}

    scene = entry._portal_scene(dev)
    ax, plf, pof, n_mat, mode = scene.fused_profile
    tri, msc, clu, n_clu = fp.pack_fused(scene, mode)
    args = (tri, msc, scene.materials.kd.contiguous(), clu, o, d,
            pid.to(torch.int32), sidx.to(torch.int32))
    kw = dict(n_tri=scene.n_tri, n_b=MAX_DEPTH + 1, ax=ax, pl_facing=plf,
              portal_facing=pof, n_mat=n_mat, seed=0, rr_threshold=1.0,
              mode=mode, n_clu=n_clu)
    out["fused_portal"] = ms_of(lambda: fp.fused_bounce(*args, **kw))

    inf = torch.full((o.shape[0],), math.inf, device=dev)
    for name, sc in (("portal_portal", entry._portal_scene(dev, "portal")),
                     ("sphere_cornell", entry._sphere_cornell(dev)),
                     ("cap_table", cap_table(dev))):
        tabs = ik.pack_scene(sc)
        counts = (sc.n_tri, sc.n_sph, sc.n_pln)
        out[f"intersect_{name}"] = ms_of(
            lambda: ik.intersect_brute(*tabs, o, d, inf, *counts),
            3 if name == "cap_table" else REPS)

    hf = entry._heightfield_cornell(dev)
    best_t, _ = bk.bvh_traverse(hf.bvh, o, d, inf, False)
    tabs = ik.pack_scene(hf, tris=False)
    out["intersect_under_bvh_camera"] = ms_of(
        lambda: ik.intersect_brute(*tabs, o, d, best_t, 0, hf.n_sph,
                                   hf.n_pln))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"package": pbrt_tpu_torch.__file__, "card": card,
                      "ms": {k: round(v, 4) for k, v in out.items()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
