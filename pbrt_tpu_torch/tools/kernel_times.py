"""Time the render path's fused and brute-force kernels and the wide-BVH
experiment kernel at the shapes their callers give them, through their
public wrappers only, so that the same script times another checkout of
the port (an earlier commit) on the same card:

    python pbrt_tpu_torch/tools/kernel_times.py [render] [kexp] [kd]
    PYTHONPATH=<other checkout> python pbrt_tpu_torch/tools/kernel_times.py

(run as a file, the script imports ``pbrt_tpu_torch`` from PYTHONPATH
first; with no argument it times ``render`` and ``kexp``). ``render``: the fused
kernel on ``_portal_scene`` (2,097,152 lanes, max_depth 4); the
brute-force kernel on 2,097,152 camera rays against the portal-strategy
portal, ``_sphere_cornell`` and a 4,001-primitive table, and at the call
shape a BVH scene gives it (``_heightfield_cornell()``'s sphere and
aaplane, tmax from the traversal, camera rays). ``kexp``: the harness's
inputs (``kexp_prep.prep``) for the 133,130-triangle heightfield tree and
the 100,000-triangle soup, 2,097,152 rays per set (primary, random,
sorted, bounce closest hit, shadow any-hit), through the wide-BVH kernel
(``kexp_kernels.traverse``) in the configurations of KEXP_CONFIGS, and
through the render path's 4-wide kernel beside them. ``kd``: the kd
cell (``_heightfield_cornell()``'s triangles in a kd-tree, a 256² ×
32-spp `path` pass at max_depth 4): the camera, shadow and bounce rays
of its walks 0, 1 and 3, recorded from the pass, and the occlusion rays
of an `ao` pass of the cell at the integrator's default radius, through
the kd walk's public wrapper (each set through the walk its pass gives
it: the occlusion rays through the any-hit walk where the package has
one, and also through the closest-hit walk), and through the render
path's 4-wide kernel on the scene's BVH, and the two passes. Prints one JSON
line: the package's path, the card and the mean ms of each launch by
CUDA events (and, where the package records it, the threads per block of
each staged launch). Needs a CUDA device.
"""

import dataclasses
import inspect
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
from pbrt_tpu_torch.ops import kdtree as kd_ops
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import kdtree as kd_mod
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import kexp_prep, kexp_run

RES, SPP, MAX_DEPTH, REPS = 256, 32, 4, 20
KEXP_REPS = 10
# label -> (wide, leaf_max, variant (5: on the dual-leaf layout), staged
# nodes: a count, or "max" for all that fit what the probe finds a launch
# gets); 1,614 is the most that fit with 16 bytes of padding a record. v2
# is staged at 1, 256, 1,024, 1,614 and all that fit: where a staged launch
# always runs the same threads per block, these rows differ only by the
# shared memory they take from L1 and the node loads it serves.
KEXP_CONFIGS = {
    "v1": (4, 16, 1, 0), "v2": (4, 16, 2, 0), "v3": (4, 16, 3, 0),
    "pack_4_8": (4, 8, 2, 0), "pack_4_4": (4, 4, 2, 0),
    "w8_l8": (8, 8, 2, 0), "dual": (4, 16, 5, 0),
    "v1_smem256": (4, 16, 1, 256),
    "v2_smem1": (4, 16, 2, 1), "v2_smem256": (4, 16, 2, 256),
    "v2_smem1024": (4, 16, 2, 1024), "v2_smem1614": (4, 16, 2, 1614),
    "v2_smem_max": (4, 16, 2, "max")}


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


def kexp_times(dev):
    """{tree: {label: {set: ms}}} of the wide-BVH kernel and the render
    path's kernel ("render"), and {tree: {label: threads}} of the staged
    launches where the package records them."""
    ms, threads = {}, {}
    for name in ("heightfield", "soup"):
        z = kexp_prep.prep(kexp_prep.make_scene(name, dev),
                           n_rays=RES * RES * SPP, res=RES, device=dev)
        sets = {sn: (*(torch.as_tensor(z[k], device=dev)
                       for k in (ok, dk, tk)), any_hit)
                for sn, ok, dk, tk, any_hit in kexp_run.RAY_SETS}
        tree = kexp_run.tree_of(z, dev)
        ms[name] = {"render": {
            sn: ms_of(lambda: bk.bvh_traverse(tree, o, d, tm, a), KEXP_REPS)
            for sn, (o, d, tm, a) in sets.items()}}
        threads[name] = {}
        for label, (wide, leaf_max, variant, smem) in KEXP_CONFIGS.items():
            lay = kexp_run.layout_of(z, dev, wide=wide, leaf_max=leaf_max,
                                     dual=variant == 5)
            if smem == "max":
                smem = kk.max_smem_nodes(lay, kk.smem_limit_kb(dev))
            ms[name][label] = {
                sn: ms_of(lambda: kk.traverse(
                    lay, o, d, tm, any_hit=a, variant=variant,
                    smem_nodes=smem), KEXP_REPS)
                for sn, (o, d, tm, a) in sets.items()}
            if smem:
                ms[name][label]["smem_nodes"] = smem
                threads[name][label] = getattr(kk.traverse, "last_threads",
                                               None)
    return ms, threads


def kd_times(dev):
    """{set: {label: ms}} of the kd walk (and kernel 3) on the kd cell's
    camera, shadow and bounce rays (walks 0, 1 and 3 of its `path` pass)
    and on the occlusion rays of an `ao` pass (the default radius) of the
    same cell; {"pass": {name: ms}} of the
    two passes."""
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b)
    scene = b.build(dev, use_bvh="never")
    kd = kd_mod.build_kdtree(scene)
    hf = b.build(dev)
    walk = kd_ops.kd_traverse

    cam = entry._camera((RES, RES), dev)
    filt = film_mod.make_filter("box", device=dev)
    scene_kd = dataclasses.replace(scene, bvh=kd)

    def walks_of(cfg):
        calls = []

        def record(kd_, o, d, tmax, *args, **kw):
            calls.append((o.clone(), d.clone(), tmax.clone()))
            return walk(kd_, o, d, tmax, *args, **kw)
        # a wrapper that counts its launches on its module's name finds
        # them
        record.launches = record.any_hit_launches = 0
        kd_ops.kd_traverse = record
        try:
            render_mod.render_pass(scene_kd, cam, filt, cfg, RES, RES, SPP,
                                   0, dev)
            torch.cuda.synchronize()
        finally:
            kd_ops.kd_traverse = walk
        return calls
    cfg_path = render_mod.RenderConfig(integrator="path", max_depth=MAX_DEPTH)
    cfg_ao = render_mod.RenderConfig(integrator="ao")
    path, ao = walks_of(cfg_path), walks_of(cfg_ao)
    has_any = "any_hit" in inspect.signature(walk).parameters
    ms = {}
    for name, rays, any_hit in (("camera", path[0], False),
                                ("shadow", path[1], False),
                                ("bounce", path[3], False),
                                ("ao", ao[1], True)):
        o, d, tmax = rays
        row = ms[name] = {}
        if any_hit and has_any:
            row["walk"] = ms_of(lambda: walk(kd, o, d, tmax, any_hit=True))
            row["walk_closest"] = ms_of(lambda: walk(kd, o, d, tmax))
        else:
            row["walk"] = ms_of(lambda: walk(kd, o, d, tmax))
        row["kernel3"] = ms_of(lambda: bk.bvh_traverse(hf.bvh, o, d, tmax,
                                                       any_hit))
    # the two passes themselves
    ms["pass"] = {name: ms_of(lambda: render_mod.render_pass(
        scene_kd, cam, filt, cfg, RES, RES, SPP, 0, dev), 3)
        for name, cfg in (("path", cfg_path), ("ao", cfg_ao))}
    return ms


def main(groups=("render", "kexp")):
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    out, line = {}, {"package": pbrt_tpu_torch.__file__}
    if "kexp" in groups:
        kms, line["kexp_threads"] = kexp_times(dev)
        line["kexp_ms"] = {t: {lab: {k: v if k == "smem_nodes" else
                                     round(v, 4) for k, v in row.items()}
                               for lab, row in rows.items()}
                           for t, rows in kms.items()}
    if "render" in groups:
        out = render_times(dev)
    if "kd" in groups:
        line["kd_ms"] = {k: {lab: round(v, 4) for lab, v in row.items()}
                         for k, row in kd_times(dev).items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    line.update(card=card, ms={k: round(v, 4) for k, v in out.items()})
    print(json.dumps(line))
    sys.stdout.flush()


def render_times(dev):
    """ms of the fused and the brute-force kernel's launches."""
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
    return out


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("render", "kexp"))
