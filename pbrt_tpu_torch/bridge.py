"""Carry a scene built by pbrt_tpu over to the port.

``scene_from_jax``, ``camera_from_jax`` and ``filter_from_jax`` turn a
built ``pbrt_tpu`` Scene, Camera and Filter into this package's objects
on a given device. Every field is read through ``np.asarray``, so this
module never imports jax itself; static fields (the primitive counts,
``n_channels``, ``fused_profile``, the tables' ``present`` and other
flags) carry over as they are, so a scene of 60-bin sampled spectra
carries its 60-channel materials, lights, power and map distribution. Only what the port models is carried: a
scene with other shape families, material types, media, textures or
motion raises. A BVH carries over as its flat node
arrays and leaf-ordered triangles, repacked by the port into its own
traversal layouts (pbrt_tpu's packet-kernel tables are left behind), so
both packages walk the same tree; a kd-tree raises. This is the tests'
tool for feeding both packages one scene, so it defaults to the CPU, where
JAX runs there; the port's own entry points default to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene.camera import Camera
from pbrt_tpu_torch.scene.film import Filter
from pbrt_tpu_torch.scene.lights import AREA, LightTable
from pbrt_tpu_torch.scene.materials import MaterialTable
from pbrt_tpu_torch.scene.bvh import _finish_flat
from pbrt_tpu_torch.scene.types import Geometry, Scene


def _t(x, device):
    return torch.as_tensor(np.array(np.asarray(x)), device=device)


def bvh_from_jax(bvh, device="cpu"):
    """pbrt_tpu's FlatBVH (or None) as the port's."""
    if bvh is None:
        return None
    if type(bvh).__name__ != "FlatBVH":
        raise NotImplementedError(
            f"bridge: accelerator {type(bvh).__name__} is not ported "
            "(scene/kdtree.py: ROADMAP queue 1 item 6)")
    if np.asarray(bvh.tri9).shape[-1] != 9:
        raise NotImplementedError("bridge: a motion-blur BVH is not ported "
                                  "(ROADMAP queue 1 item 8)")
    return _finish_flat(*(np.asarray(getattr(bvh, k)) for k in (
        "lo", "hi", "right", "count", "axis", "prim_order", "v0", "v1",
        "v2")), device=device, built_by="bridge")


def scene_from_jax(scene, device="cpu") -> Scene:
    extra = {k: getattr(scene, k, 0) for k in ("n_crv", "n_vprims")}
    extra.update({k: getattr(scene, k, None) is not None
                  for k in ("textures", "inst", "sss")})
    extra.update({k: bool(getattr(scene, k, False))
                  for k in ("has_motion", "has_sss", "media", "fourier")})
    if any(extra.values()):
        raise NotImplementedError(
            f"bridge: only triangles, spheres, aaplanes and disks without "
            f"media, textures or motion are ported ({extra})")
    g, lt = scene.geom, scene.lights
    ltype = np.asarray(lt.ltype)
    return Scene(
        geom=Geometry(**{k: _t(getattr(g, k), device) for k in (
            "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
            "tri_uv0", "tri_uv1", "tri_uv2", "sph_center", "sph_radius",
            "pln_lo", "pln_hi", "pln_ax", "pln_facing", "dsk_center",
            "dsk_normal", "dsk_radius", "dsk_inner")}),
        prim_mat=_t(scene.prim_mat, device),
        prim_light=_t(scene.prim_light, device),
        materials=materials_from_jax(scene.materials, device),
        lights=LightTable(
            **{k: _t(getattr(lt, k), device) for k in (
                "ltype", "emit", "pos", "dir", "cos_total", "cos_falloff",
                "prim_id", "two_sided", "strategy", "n_portals", "portal_lo",
                "portal_hi", "portal_ax", "portal_facing", "gonio_map",
                "proj_fov", "env_map", "power")},
            env_distr=Distribution2D(
                *(Distribution1D(*(_t(getattr(d, k), device) for k in (
                    "func", "cdf", "func_int")))
                  for d in (lt.env_distr.cond, lt.env_distr.marginal))),
            present=tuple(lt.present), has_portals=bool(lt.has_portals),
            has_plain_area=bool(((ltype == AREA)
                                 & (np.asarray(lt.n_portals) == 0)).any())),
        world_lo=_t(scene.world_lo, device),
        world_hi=_t(scene.world_hi, device),
        n_tri=int(scene.n_tri), n_sph=int(scene.n_sph),
        n_pln=int(scene.n_pln), n_channels=int(scene.n_channels),
        bvh=bvh_from_jax(scene.bvh, device), n_dsk=int(scene.n_dsk),
        fused_profile=scene.fused_profile)


def materials_from_jax(m, device="cpu") -> MaterialTable:
    """pbrt_tpu's MaterialTable as the port's: every field of the ported
    families and the static flags. A row of another type, a textured
    parameter or a DisneyBSSRDF row raises, as ``check_row`` does."""
    for t in np.unique(np.asarray(m.mtype)):
        mat_mod.check_row({"type": int(t)})
    for k in ("kd_tex", "sigma_tex", "bump_tex", "fourier_id"):
        if (np.asarray(getattr(m, k)) != -1).any():
            mat_mod.check_row({k: 0})
    if m.has_disney_sss:
        mat_mod.check_row({"type": mat_mod.DISNEY, "scatter_d": 1.0})
    return MaterialTable(
        **{k: _t(getattr(m, k), device) for k in mat_mod.tensor_fields()},
        has_beckmann=bool(m.has_beckmann),
        has_disney_trans=bool(m.has_disney_trans),
        present=tuple(m.present))


def camera_from_jax(cam, device="cpu") -> Camera:
    if getattr(cam, "anim", None) is not None:
        raise NotImplementedError("bridge: a moving camera is not ported "
                                  "(motion blur: ROADMAP queue 1 item 8)")
    res = np.asarray(cam.resolution)
    return Camera(
        cam_type=int(np.asarray(cam.cam_type)),
        cam_to_world=Transform(_t(cam.cam_to_world.m, device),
                               _t(cam.cam_to_world.m_inv, device)),
        **{k: _t(getattr(cam, k), device).to(torch.float32) for k in (
            "screen_min", "screen_max", "lens_radius", "focal_distance",
            "fov_scale")},
        resolution=(int(res[0]), int(res[1])))


def filter_from_jax(filt, device="cpu") -> Filter:
    if filt.is_box:
        return Filter(radius=_t(filt.radius, device))
    return Filter(radius=_t(filt.radius, device), is_box=False,
                  **{k: _t(getattr(filt, k), device) for k in (
                      "inv_cdf", "inv_cdf_y", "w_x", "w_y")})
