"""Perspective (thin lens), orthographic and environment cameras (port of
pbrt_tpu/scene/camera.py:33-209): ray generation, and the perspective
camera's importance (``camera_we``) and directional density
(``camera_pdf_dir``) that bidirectional path tracing reads.

Every camera carries its shutter interval; an animated camera (differing
start and end CTMs in the scene file) also an ``AnimatedTransform``,
whose per-ray matrix at the ray's shutter time replaces the
camera-to-world transform (core/api.cpp:814's CameraToWorld).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import AnimatedTransform, Transform
from pbrt_tpu_torch.core.vecmath import Ray, length, make_ray, normalize

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
    shutter_open: torch.Tensor = None    # () (make_* set both)
    shutter_close: torch.Tensor = None   # ()
    # camera motion blur: the per-ray camera-to-world at the ray's time
    anim: Optional[AnimatedTransform] = None


def make_perspective(cam_to_world: Transform, fov_deg: float, resolution,
                     lens_radius: float = 0.0, focal_distance: float = 1e6,
                     screen_window=None, device="cpu",
                     shutter_open: float = 0.0,
                     shutter_close: float = 1.0) -> Camera:
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
        resolution=(nx, ny), shutter_open=f32(shutter_open),
        shutter_close=f32(shutter_close))


def make_orthographic(cam_to_world: Transform, resolution,
                      screen_window=None, lens_radius: float = 0.0,
                      focal_distance: float = 1e6, device="cpu") -> Camera:
    cam = make_perspective(cam_to_world, 90.0, resolution, lens_radius,
                           focal_distance, screen_window=screen_window,
                           device=device)
    return dataclasses.replace(
        cam, cam_type=ORTHOGRAPHIC,
        fov_scale=torch.ones((), device=cam.fov_scale.device))


def make_environment(cam_to_world: Transform, resolution,
                     device="cpu") -> Camera:
    return dataclasses.replace(
        make_perspective(cam_to_world, 90.0, resolution, device=device),
        cam_type=ENVIRONMENT)


def generate_rays(cam: Camera, p_film: torch.Tensor, u_lens: torch.Tensor,
                  u_time: torch.Tensor) -> Ray:
    """p_film: (R,2) raster positions; u_lens: (R,2) lens samples; u_time:
    (R,) shutter samples, which move an animated camera (the ray's time is
    shutter_open + u_time·(shutter_close − shutter_open)).
    PerspectiveCamera::GenerateRay (cameras/perspective.cpp:63-93),
    OrthographicCamera::GenerateRay and EnvironmentCamera::GenerateRay."""
    o, d = _camera_space_rays(cam, p_film, u_lens)
    if cam.anim is not None:
        # camera motion blur: the camera-to-world at each ray's time
        # (AnimatedTransform::Interpolate, core/camera.cpp GenerateRay's
        # ray.time), applied as elementwise sums (no matmul)
        time = cam.shutter_open + u_time * (cam.shutter_close
                                            - cam.shutter_open)
        m = cam.anim.interpolate(time)               # (R,4,4)

        def rot(v):
            return (m[:, :3, 0] * v[:, 0:1] + m[:, :3, 1] * v[:, 1:2]
                    + m[:, :3, 2] * v[:, 2:3])
        return make_ray(rot(o) + m[:, :3, 3], rot(d))
    return make_ray(cam.cam_to_world.apply_point(o),
                    cam.cam_to_world.apply_vector(d))


def _camera_space_rays(cam: Camera, p_film, u_lens):
    """The rays (o, d) in camera space."""
    res = torch.tensor(cam.resolution, dtype=torch.float32,
                       device=p_film.device)
    # raster → NDC → screen; raster-to-screen flips y
    ndc = p_film / res
    if cam.cam_type == ENVIRONMENT:
        # latitude–longitude over the whole sphere, from the unflipped ndc
        theta = math.pi * ndc[..., 1]
        phi = 2.0 * math.pi * ndc[..., 0]
        d = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                         torch.sin(theta) * torch.sin(phi)], dim=-1)
        return torch.zeros_like(d), d
    sx = cam.screen_min[0] + ndc[..., 0] * (cam.screen_max[0]
                                            - cam.screen_min[0])
    sy = -(cam.screen_min[1] + ndc[..., 1]
           * (cam.screen_max[1] - cam.screen_min[1]))
    if cam.cam_type == ORTHOGRAPHIC:
        # origin on the film plane, direction +z
        o = torch.stack([sx, sy, torch.zeros_like(sx)], dim=-1)
        d = torch.tensor([0.0, 0.0, 1.0], device=o.device).expand(o.shape)
    else:
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
    return o, d


def _perspective_only(cam: Camera, what: str):
    """pbrt_tpu's ``camera_we`` and ``camera_pdf_dir`` read the
    perspective camera's screen window whatever the camera is, so they
    return wrong values for the orthographic and environment cameras
    (ROADMAP queue 3). The port raises instead."""
    if cam.cam_type != PERSPECTIVE:
        name = {ORTHOGRAPHIC: "orthographic",
                ENVIRONMENT: "environment"}[cam.cam_type]
        raise NotImplementedError(
            f"{what} of an {name} camera: only the perspective camera has "
            "an importance function (bidirectional path tracing needs it)")


def _screen_area(cam: Camera) -> torch.Tensor:
    """Area of the screen window at z = 1 in camera space."""
    return ((cam.screen_max[0] - cam.screen_min[0]) * cam.fov_scale
            * (cam.screen_max[1] - cam.screen_min[1]) * cam.fov_scale)


def camera_pdf_dir(cam: Camera, ray_d_world: torch.Tensor) -> torch.Tensor:
    """Directional density of GenerateRay for a perspective camera:
    p(ω) = 1/(A·cos³θ) with A the screen area at z=1
    (PerspectiveCamera::Pdf_We, cameras/perspective.cpp:158-176)."""
    _perspective_only(cam, "the directional density")
    d_cam = cam.cam_to_world.inverse().apply_vector(ray_d_world)
    cos_theta = torch.clamp_min(
        d_cam[..., 2] / torch.clamp_min(length(d_cam), 1e-9), 1e-4)
    return 1.0 / (_screen_area(cam) * cos_theta ** 3)


def camera_we(cam: Camera, ray_o: torch.Tensor, ray_d: torch.Tensor):
    """Importance We(ray) + raster position (perspective.cpp:120-155).
    Returns (we (R,), p_raster (R,2), valid (R,))."""
    _perspective_only(cam, "the importance")
    w2c = cam.cam_to_world.inverse()
    d_cam = w2c.apply_vector(ray_d)
    len_d = torch.clamp_min(length(d_cam), 1e-9)
    cos_theta = d_cam[..., 2] / len_d
    valid = cos_theta > 1e-6
    o_cam = w2c.apply_point(ray_o)
    ft = torch.where(cam.lens_radius > 0, cam.focal_distance, 1.0)
    p_focus = o_cam + (ft / torch.clamp_min(cos_theta, 1e-6))[..., None] \
        * d_cam / len_d[..., None]
    z = torch.clamp_min(p_focus[..., 2], 1e-6)
    sx = p_focus[..., 0] / z / cam.fov_scale
    sy = p_focus[..., 1] / z / cam.fov_scale
    ndc_x = (sx - cam.screen_min[0]) / (cam.screen_max[0]
                                        - cam.screen_min[0])
    ndc_y = (-sy - cam.screen_min[1]) / (cam.screen_max[1]
                                         - cam.screen_min[1])
    res_x, res_y = float(cam.resolution[0]), float(cam.resolution[1])
    p_raster = torch.stack([ndc_x * res_x, ndc_y * res_y], dim=-1)
    inside = ((p_raster[..., 0] >= 0) & (p_raster[..., 0] < res_x)
              & (p_raster[..., 1] >= 0) & (p_raster[..., 1] < res_y))
    valid = valid & inside
    lens_area = torch.where(cam.lens_radius > 0,
                            math.pi * cam.lens_radius ** 2, 1.0)
    c2 = cos_theta * cos_theta
    we = torch.where(valid, 1.0 / (_screen_area(cam) * lens_area * c2 * c2),
                     0.0)
    return we, p_raster, valid
