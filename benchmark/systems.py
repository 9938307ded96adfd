"""The system under test, as the driver sees it.

``Program`` is pbrt_tpu_torch: the scene from its front end
(``frontend/parser.py``), the settings from the configuration's file
(integrator, sampler, filter, max_depth: the reference is given the
same, and neither reads the scene file's own), images from
``integrators/render.py::render``, the training step from
``parallel/render.py::make_train_step`` over a ``make_mesh`` of the
process group that ``parallel/multihost.py`` sets up. Nothing else of
the benchmark imports pbrt_tpu_torch.

``Control`` puts the configuration's plain reference in the program's
place, computed in bfloat16, the precision below the configuration's
float32: the control that the comparison deciding ``correct`` has to
fail. ``ControlRays`` computes it in float32 with only its camera rays
rounded to bfloat16, the step nearest to a later change (the camera rays
are the main path's largest share). The benchmark's own runs never use
either (``control.py`` does).

Parameters are {"kd": (M, 3), "emit": (..., 3)} in the system's own
shapes; ``flat`` gives the comparison a (n,) float64 view of a leaf.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from benchmark import spec


def flat(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).to(torch.float64)


class Program:
    name = "program"

    def __init__(self, config: dict, device):
        from pbrt_tpu_torch.frontend import load_pbrt

        self.config = config
        self.device = torch.device(device)
        self.scene, self.cam, _ = load_pbrt(str(spec.ROOT / config["scene"]),
                                            device=self.device)

    def own_params(self):
        return {"kd": self.scene.materials.kd, "emit": self.scene.lights.emit}

    def _cam(self, width, height):
        if tuple(self.cam.resolution) == (width, height):
            return self.cam
        if width * self.cam.resolution[1] != height * self.cam.resolution[0]:
            raise ValueError("a traffic resolution keeps the film's aspect")
        return dataclasses.replace(self.cam, resolution=(width, height))

    def render(self, width, height, spp, chunk_spp, seed, progress=None):
        from pbrt_tpu_torch.integrators.render import render

        c = self.config
        return render(self.scene, self._cam(width, height), spp=spp,
                      integrator=c["integrator"], sampler=c["sampler"],
                      filter_name=c["filter"], max_depth=c["max_depth"],
                      seed=seed, chunk_spp=chunk_spp, progress=progress,
                      device=self.device)

    def init_group(self, port, world, rank):
        from pbrt_tpu_torch.parallel import initialize_multihost

        initialize_multihost(f"localhost:{port}", world, rank, self.device)

    def mesh(self, shape):
        from pbrt_tpu_torch.parallel import make_mesh

        return make_mesh(dist.get_world_size(), shape=shape)

    def render_sharded(self, mesh, width, height, spp, seed):
        from pbrt_tpu_torch.parallel import render_sharded

        c = self.config
        return render_sharded(self.scene, self._cam(width, height), mesh,
                              spp=spp,
                              integrator=c["integrator"],
                              sampler=c["sampler"], filter_name=c["filter"],
                              max_depth=c["max_depth"], seed=seed,
                              resolution=(width, height))

    def train_step(self, mesh, width, height, spp, seed, params, target,
                   lr):
        from pbrt_tpu_torch.parallel import make_train_step

        c = self.config
        if (c["sampler"], c["filter"]) != ("independent", "box"):
            raise ValueError("make_train_step renders with the independent "
                             "sampler and the box filter only")
        step = make_train_step(mesh, spp=spp,
                               integrator=self.config["integrator"],
                               max_depth=self.config["max_depth"], seed=seed,
                               resolution=(width, height))
        return step(self.scene, self._cam(width, height), params, target,
                    lr)


@dataclasses.dataclass
class _Mesh:
    dp: int
    sp: int
    dp_index: int
    sp_index: int


class Control:
    """The reference in the program's place, in bfloat16."""
    name = "control"
    dtype = torch.bfloat16
    ray_dtype = None

    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.ref = spec.reference(config["reference"])
        self.sc = self.ref.load(str(spec.ROOT / config["scene"]), config,
                                self.device, self.dtype)

    def own_params(self):
        return {"kd": self.sc.kd, "emit": self.sc.emit}

    def _region(self, kd, emit, width, height, samples, seed, rows=None):
        return self.ref.render_region(self.sc, kd, emit, width, height,
                                      samples, seed, rows=rows,
                                      dtype=self.dtype,
                                      ray_dtype=self.ray_dtype)

    def render(self, width, height, spp, chunk_spp, seed, progress=None):
        img = 0
        chunk = chunk_spp or spp
        for a in range(0, spp, chunk):
            img = img + self._region(self.sc.kd, self.sc.emit, width,
                                     height, range(a, min(a + chunk, spp)),
                                     seed).detach()
            if progress is not None:
                progress.update(min(chunk, spp - a))
        return img / spp

    def init_group(self, port, world, rank):
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)

    def mesh(self, shape):
        dp, sp = shape
        r = dist.get_rank()
        return _Mesh(dp, sp, r // sp, r % sp)

    def _share(self, mesh, height, spp):
        chunk = spp // mesh.dp
        rows = height // mesh.sp
        return (range(mesh.dp_index * chunk, (mesh.dp_index + 1) * chunk),
                range(mesh.sp_index * rows, (mesh.sp_index + 1) * rows))

    def render_sharded(self, mesh, width, height, spp, seed):
        samples, rows = self._share(mesh, height, spp)
        full = torch.zeros((height, width, 3), dtype=self.dtype,
                           device=self.device)
        full[rows.start:rows.stop] = self._region(
            self.sc.kd, self.sc.emit, width, height, samples, seed,
            rows).detach()
        dist.all_reduce(full)
        return full / spp

    def train_step(self, mesh, width, height, spp, seed, params, target,
                   lr):
        losses, _, new = self.ref.train(
            self.sc, params["kd"], params["emit"], target, [seed], width,
            height, spp, lr, region=self._share(mesh, height, spp),
            all_reduce=dist.all_reduce, dtype=self.dtype,
            ray_dtype=self.ray_dtype)
        return new, torch.tensor(losses[0])


class ControlRays(Control):
    """The reference in the program's place, in float32 with bfloat16
    camera rays."""
    name = "control_rays"
    dtype = torch.float32
    ray_dtype = torch.bfloat16


SYSTEMS = {"program": Program, "control": Control,
           "control_rays": ControlRays}
