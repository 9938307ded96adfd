"""Perspective camera with thin lens (port of pbrt_tpu/scene/camera.py:33-164).

Orthographic and environment cameras and camera motion blur (shutter
times) are not ported yet; the first two raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.core.vecmath import Ray, make_ray, normalize

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
ENVIRONMENT = 2


@dataclasses.dataclass
class Camera:
    cam_type: int
    cam_to_world: Transform
    screen_min: torch.Tensor      # (2,) screen window lower corner
    screen_max: torch.Tensor      # (2,)
    lens_radius: torch.Tensor     # ()
    focal_distance: torch.Tensor  # ()
    fov_scale: torch.Tensor       # () tan(fov/2)
    resolution: tuple             # (nx, ny)


def make_perspective(cam_to_world: Transform, fov_deg: float, resolution,
                     lens_radius: float = 0.0, focal_distance: float = 1e6,
                     screen_window=None, device="cpu") -> Camera:
    nx, ny = int(resolution[0]), int(resolution[1])
    aspect = nx / ny
    if screen_window is None:
        # core/api.cpp MakeCamera: screen window from aspect
        if aspect > 1.0:
            smin, smax = (-aspect, -1.0), (aspect, 1.0)
        else:
            smin, smax = (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)
    else:
        smin, smax = screen_window

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return Camera(
        cam_type=PERSPECTIVE, cam_to_world=cam_to_world,
        screen_min=f32(smin), screen_max=f32(smax),
        lens_radius=f32(lens_radius), focal_distance=f32(focal_distance),
        fov_scale=f32(np.tan(np.radians(fov_deg) / 2.0)),
        resolution=(nx, ny))


def generate_rays(cam: Camera, p_film: torch.Tensor, u_lens: torch.Tensor,
                  u_time: torch.Tensor) -> Ray:
    """p_film: (R,2) raster positions; u_lens: (R,2) lens samples; u_time
    is accepted for the reference's signature (no camera motion here).
    PerspectiveCamera::GenerateRay (cameras/perspective.cpp:63-93)."""
    if cam.cam_type != PERSPECTIVE:
        raise NotImplementedError(
            "orthographic/environment cameras: ROADMAP queue 1 item 8")
    res = torch.tensor(cam.resolution, dtype=torch.float32,
                       device=p_film.device)
    # raster → NDC → screen; raster-to-screen flips y
    ndc = p_film / res
    sx = cam.screen_min[0] + ndc[..., 0] * (cam.screen_max[0]
                                            - cam.screen_min[0])
    sy = -(cam.screen_min[1] + ndc[..., 1]
           * (cam.screen_max[1] - cam.screen_min[1]))
    d = normalize(torch.stack(
        [sx * cam.fov_scale, sy * cam.fov_scale, torch.ones_like(sx)],
        dim=-1))
    o = torch.zeros_like(d)

    # thin-lens depth of field (perspective.cpp:74-86), selected per
    # element like the reference so no host sync is needed
    lens_r = cam.lens_radius
    p_lens = lens_r * concentric_sample_disk(u_lens)
    ft = cam.focal_distance / torch.clamp_min(d[..., 2].abs(), 1e-6)
    p_focus = o + ft[..., None] * d
    o_dof = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1)
    d_dof = normalize(p_focus - o_dof)
    use_dof = lens_r > 0.0
    o = torch.where(use_dof, o_dof, o)
    d = torch.where(use_dof, d_dof, d)
    return make_ray(cam.cam_to_world.apply_point(o),
                    cam.cam_to_world.apply_vector(d))
