"""Carry a scene built by pbrt_tpu over to the port.

``scene_from_jax``, ``camera_from_jax`` and ``filter_from_jax`` turn a
built ``pbrt_tpu`` Scene, Camera and Filter into this package's objects
on a given device. Every field is read through ``np.asarray``, so this
module never imports jax itself; static fields (the primitive counts,
``n_channels``, ``fused_profile``, the tables' ``present`` and other
flags) carry over as they are, so a scene of 60-bin sampled spectra
carries its 60-channel materials, lights, power and map distribution.
Textures (the table and its mip-atlas stack), instanced objects and media
(with the per-prim media interface and the camera's medium; a legacy
scene-global ``camera_medium`` becomes medium 0 of the camera) carry over,
and so do subsurface scattering's ``has_sss`` and BSSRDF tables
(subsurface and Disney scatterdistance rows) and two-keyframe motion
(``has_motion``, the triangles' ``tri_dv0..2``, an animated camera's
keyframes and the shutter), cubic Bézier curves (``crv_*``, ``n_crv``),
hair rows and the Fourier tables. A BVH carries over as its
flat node arrays and leaf-ordered triangles (with their motion, read from
its 18-column rows), repacked by the port into its own traversal layouts
(pbrt_tpu's packet-kernel tables are left behind), so both packages walk
the same tree; a kd-tree carries over array for array, with the port's
kernel layout packed from it. This is the tests'
tool for feeding both packages one scene, so it defaults to the CPU, where
JAX runs there; the port's own entry points default to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.core.transform import AnimatedTransform, Transform
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene.camera import Camera
from pbrt_tpu_torch.scene.film import Filter
from pbrt_tpu_torch.scene.lights import AREA, LightTable
from pbrt_tpu_torch.scene.materials import MaterialTable
from pbrt_tpu_torch.scene.bssrdf import SSSTables
from pbrt_tpu_torch.scene.fourier import FourierTable
from pbrt_tpu_torch.scene.bvh import _finish_flat
from pbrt_tpu_torch.scene.instances import InstanceTable
from pbrt_tpu_torch.scene.kdtree import make_kdtree
from pbrt_tpu_torch.scene.media import Medium
from pbrt_tpu_torch.scene.textures import TextureTable
from pbrt_tpu_torch.scene.types import Geometry, Scene


def _t(x, device):
    return torch.as_tensor(np.array(np.asarray(x)), device=device)


def bvh_from_jax(bvh, device="cpu"):
    """pbrt_tpu's FlatBVH or KdTree (or None) as the port's."""
    if bvh is None:
        return None
    if type(bvh).__name__ == "KdTree":
        return make_kdtree(*(np.asarray(getattr(bvh, k)) for k in (
            "split_pos", "axis", "above_child", "n_prims", "prim_ids",
            "world_lo", "world_hi", "v0", "v1", "v2")), int(bvh.max_leaf),
            device=device)
    if type(bvh).__name__ != "FlatBVH":
        raise NotImplementedError(
            f"bridge: accelerator {type(bvh).__name__} is not pbrt_tpu's "
            "FlatBVH or KdTree")
    tri9 = np.asarray(bvh.tri9)
    n = np.asarray(bvh.prim_order).shape[0]
    dv = None
    if tri9.shape[-1] == 18:
        # a motion tree: the leaf-ordered motion in columns 9-17
        dv = tuple(tri9[:n, c:c + 3] for c in (9, 12, 15))
    return _finish_flat(*(np.asarray(getattr(bvh, k)) for k in (
        "lo", "hi", "right", "count", "axis", "prim_order", "v0", "v1",
        "v2")), device=device, built_by="bridge", dv=dv)


def _fields_from_jax(cls, obj, device, **static):
    """A port dataclass ``cls`` from pbrt_tpu's ``obj``: every tensor
    field read from the same name, the static ones given."""
    return cls(**{f.name: _t(getattr(obj, f.name), device)
                  for f in dataclasses.fields(cls)
                  if f.type == "torch.Tensor"}, **static)


def textures_from_jax(tt, device="cpu"):
    if tt is None:
        return None
    return _fields_from_jax(
        TextureTable, tt, device, ewa=bool(tt.ewa),
        max_aniso=float(tt.max_aniso), nest_depth=int(tt.nest_depth),
        present=tuple(sorted(set(np.asarray(tt.ttype).tolist()))))


def instances_from_jax(it, device="cpu"):
    if it is None:
        return None
    return _fields_from_jax(
        InstanceTable, it, device, obj_layout=tuple(
            tuple(int(x) for x in row) for row in it.obj_layout),
        inst_order=tuple(int(i) for i in np.asarray(it.inst_ids)))


def medium_from_jax(med, device="cpu") -> Medium:
    return _fields_from_jax(Medium, med, device, is_grid=bool(med.is_grid))


def sss_from_jax(tabs, device="cpu"):
    """pbrt_tpu's SSSTables (or None) as the port's."""
    if tabs is None:
        return None
    return _fields_from_jax(SSSTables, tabs, device)


def fourier_from_jax(tables, device="cpu") -> tuple:
    """pbrt_tpu's tuple of FourierTables as the port's."""
    return tuple(_fields_from_jax(FourierTable, tb, device,
                                  n_channels=int(tb.n_channels),
                                  m_max=int(tb.m_max)) for tb in tables)


def scene_from_jax(scene, device="cpu") -> Scene:
    n_crv = int(scene.n_crv)
    g = scene.geom
    curves = {} if not n_crv else {
        k: None if getattr(g, k) is None else _t(getattr(g, k), device)
        for k in ("crv_cp", "crv_w", "crv_n")}
    has_motion = bool(scene.has_motion)
    media = tuple(medium_from_jax(m, device) for m in scene.media)
    camera_med = int(scene.camera_med)
    if not media and getattr(scene, "camera_medium", None) is not None:
        media, camera_med = (medium_from_jax(scene.camera_medium,
                                             device),), 0
    lt = scene.lights
    ltype = np.asarray(lt.ltype)
    return Scene(
        geom=Geometry(**{k: _t(getattr(g, k), device) for k in (
            "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
            "tri_uv0", "tri_uv1", "tri_uv2", "sph_center", "sph_radius",
            "pln_lo", "pln_hi", "pln_ax", "pln_facing", "dsk_center",
            "dsk_normal", "dsk_radius", "dsk_inner")
            + (("tri_dv0", "tri_dv1", "tri_dv2") if has_motion else ())},
            **curves),
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
        fused_profile=scene.fused_profile,
        textures=textures_from_jax(scene.textures, device),
        inst=instances_from_jax(scene.inst, device),
        n_vprims=int(scene.n_vprims), media=media,
        prim_med_in=_t(scene.prim_med_in, device),
        prim_med_out=_t(scene.prim_med_out, device), camera_med=camera_med,
        has_sss=bool(scene.has_sss), sss=sss_from_jax(scene.sss, device),
        has_motion=has_motion, n_crv=n_crv,
        fourier=fourier_from_jax(scene.fourier, device))


def materials_from_jax(m, device="cpu") -> MaterialTable:
    """pbrt_tpu's MaterialTable as the port's: every field, the kd texture
    rows and the static flags. A textured sigma or bump raises, as
    ``check_row`` does."""
    for k in ("sigma_tex", "bump_tex"):
        if (np.asarray(getattr(m, k)) != -1).any():
            mat_mod.check_row({k: 0})
    return MaterialTable(
        **{k: _t(getattr(m, k), device) for k in mat_mod.tensor_fields()},
        has_beckmann=bool(m.has_beckmann),
        has_disney_trans=bool(m.has_disney_trans),
        has_disney_sss=bool(m.has_disney_sss),
        has_hair=bool(m.has_hair), has_fourier=bool(m.has_fourier),
        present=tuple(m.present))


def camera_from_jax(cam, device="cpu") -> Camera:
    res = np.asarray(cam.resolution)
    anim = None
    if getattr(cam, "anim", None) is not None:
        anim = AnimatedTransform(**{
            f.name: _t(getattr(cam.anim, f.name), device).to(torch.float32)
            for f in dataclasses.fields(AnimatedTransform)})
    return Camera(
        cam_type=int(np.asarray(cam.cam_type)),
        cam_to_world=Transform(_t(cam.cam_to_world.m, device),
                               _t(cam.cam_to_world.m_inv, device)),
        **{k: _t(getattr(cam, k), device).to(torch.float32) for k in (
            "screen_min", "screen_max", "lens_radius", "focal_distance",
            "fov_scale", "shutter_open", "shutter_close")},
        resolution=(int(res[0]), int(res[1])), anim=anim)


def filter_from_jax(filt, device="cpu") -> Filter:
    if filt.is_box:
        return Filter(radius=_t(filt.radius, device))
    return Filter(radius=_t(filt.radius, device), is_box=False,
                  **{k: _t(getattr(filt, k), device) for k in (
                      "inv_cdf", "inv_cdf_y", "w_x", "w_y")})
