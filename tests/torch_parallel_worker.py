"""One rank of tests/test_torch_parallel.py's process group.

``python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR`` joins a
gloo group of WORLD processes on 127.0.0.1:PORT (the port's
``parallel.initialize_multihost`` with ``device="cpu"``), runs the cases
of its world size through the port's sharded render and training step
(tests/test_parallel.py's scenes, built by the port's SceneBuilder) and
writes what it got to OUT_DIR/rank<RANK>.npz. It imports no JAX and
nothing of pbrt_tpu: the test compares the files with the port's
single-process renders and with pbrt_tpu.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pbrt_tpu_torch import entry  # noqa: E402
from pbrt_tpu_torch.core import spectrum, transform  # noqa: E402
from pbrt_tpu_torch.parallel import multihost, render as prender  # noqa
from pbrt_tpu_torch.scene import camera as cam_mod  # noqa: E402
from pbrt_tpu_torch.scene import media  # noqa: E402
from pbrt_tpu_torch.scene.types import SceneBuilder  # noqa: E402


def scene(kind="box"):
    """tests/test_parallel.py's scenes: "box" (``_scene``), "hero" (a
    floor and a point light in 60-bin spectra), "spatial" (two point
    lights of very different power), "volpath" / "grid" (the box in a
    homogeneous / density-grid camera medium)."""
    b = SceneBuilder(spectrum.SAMPLED if kind == "hero" else spectrum.RGB)
    white = b.add_material(type=0, kd=(0.7, 0.7, 0.7))
    b.add_mesh([(-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    if kind == "hero":
        b.add_light(type="point", I=10.0, pos=(0, 2, -1))
        return b.build("cpu")
    if kind == "spatial":
        b.add_mesh([(-2, 0, 2), (2, 0, 2), (2, 3, 2), (-2, 3, 2)],
                   [(0, 1, 2), (0, 2, 3)], mat=white)
        b.add_light(type="point", I=25.0, pos=(1.5, 2.0, -1.0))
        b.add_light(type="point", I=0.5, pos=(-1.5, 2.0, -1.0))
        return b.build("cpu")
    red = b.add_material(type=0, kd=(0.6, 0.1, 0.1))
    b.add_mesh([(-2, 0, 2), (2, 0, 2), (2, 3, 2), (-2, 3, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=red)
    b.add_mesh([(-0.5, 0, 0), (0.5, 0, 0), (0.5, 1, 0), (-0.5, 1, 0)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    b.add_light(type="point", I=12.0, pos=(0, 2.5, -1.5))
    s = b.build("cpu")
    if kind == "volpath":
        med = media.make_homogeneous(0.05, 0.1, 0.0)
    elif kind == "grid":
        rng = np.random.RandomState(0)
        dens = 0.4 + 0.6 * rng.rand(8, 8, 8).astype(np.float32)
        med = media.make_grid(0.08, 0.15, dens, (-2, 0, -2), (2, 3, 2))
    else:
        return s
    return dataclasses.replace(s, media=(med,), camera_med=0)


def cam(res=(16, 16)):
    return cam_mod.make_perspective(
        transform.look_at((0, 1.2, -3), (0, 0.8, 0), (0, 1, 0)), 45.0, res)


# (name, mesh shape, scene, resolution, render_sharded keywords)
RENDERS = {
    2: [("dp2", (2, 1), "box", (16, 16), dict(spp=8, max_depth=2)),
        ("sp2", (1, 2), "box", (16, 16), dict(spp=8, max_depth=2))],
    4: [("dp2sp2", (2, 2), "box", (16, 16), dict(spp=8, max_depth=2)),
        ("nondiv", (2, 2), "box", (16, 19), dict(spp=5, max_depth=2)),
        ("dp4", (4, 1), "box", (16, 16), dict(spp=19, max_depth=2)),
        ("volpath", (2, 2), "volpath", (8, 8),
         dict(spp=8, max_depth=2, integrator="volpath")),
        ("hero", (2, 2), "hero", (8, 8),
         dict(spp=4, max_depth=2, integrator="hero_path_mis")),
        ("grid", (2, 2), "grid", (8, 8),
         dict(spp=8, max_depth=2, integrator="volpath")),
        ("spatial", (2, 2), "spatial", (8, 8),
         dict(spp=8, max_depth=2, light_strategy="spatial")),
        ("uniform", (2, 2), "spatial", (8, 8),
         dict(spp=8, max_depth=2, light_strategy="uniform"))],
}
# the step: tests/test_parallel.py's grads case (8², spp 4, depth 2,
# seed 0, lr 0.5, target 0) and two cached steps (target 0.05, lr 0.3)
STEP = dict(spp=4, max_depth=2, seed=0)


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    got = multihost.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                         device="cpu")
    out = {"world": got,
           "again": multihost.initialize_multihost(device="cpu")}
    meshes = {}
    for name, shape, kind, res, kw in RENDERS[world]:
        if shape not in meshes:
            meshes[shape] = prender.make_mesh(shape=shape)
        img = prender.render_sharded(scene(kind), cam(res), meshes[shape],
                                     **kw)
        out[f"img_{name}"] = img.numpy()
    m = prender.make_mesh()
    out["default_shape"] = np.asarray([m.shape["dp"], m.shape["sp"]])
    mh = multihost.make_multihost_mesh()
    out["multihost_shape"] = np.asarray([mh.shape["dp"], mh.shape["sp"]])
    if world == 4:
        s, c = scene(), cam((8, 8))
        mesh = meshes[(2, 2)]
        params = {"kd": s.materials.kd, "emit": s.lights.emit}
        new, loss = prender.inverse_render_step(
            s, c, mesh, torch.zeros(8, 8, 3), params, lr=0.5, **STEP)
        out.update(step_loss=float(loss), step_kd=new["kd"].numpy(),
                   step_emit=new["emit"].numpy())
        s1 = prender.make_train_step(mesh, resolution=(8, 8), **STEP)
        s2 = prender.make_train_step(mesh, resolution=(8, 8), **STEP)
        target = torch.full((8, 8, 3), 0.05)
        p1, l1 = s1(s, c, params, target, 0.3)
        _, l2 = s1(s, c, p1, target, 0.3)
        out.update(cached=s1 is s2, cached_losses=np.asarray(
            [float(l1), float(l2)]))
    if world == 2:
        out["dryrun"] = np.asarray(list(entry.dryrun_multichip(
            2, "cpu").values())[1:])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
