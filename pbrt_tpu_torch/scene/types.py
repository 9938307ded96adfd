"""Scene container and host-side builder (port of the triangle, sphere,
aaplane and disk subset of pbrt_tpu/scene/types.py).

The global primitive index space is pbrt_tpu's: triangles ``[0, nT)``,
then spheres ``[nT, nT+nS)``, then aaplanes, then disks. ``prim_mat`` /
``prim_light`` map a global prim to its material row and light row (−1 =
not emissive).

``Scene.bvh`` is the triangles' BVH (scene/bvh.py::FlatBVH) or None;
``SceneBuilder.build`` makes one for scenes of more than 256 triangles, as
pbrt_tpu does. Disks are intersected outside the kernels, in plain torch,
as pbrt_tpu does (scene/intersect.py). Emissive disks, curves, instancing,
media, textures, motion and the kd-tree belong to later slices and raise
``NotImplementedError``. A scene's spectra have 3 channels (RGB) or 60
(sampled, for the hero-wavelength integrators): the builder's
``SpectrumConfig`` decides, and lifts RGB parameters to 60 bins with
``core/spectrum.py::from_rgb``, as pbrt_tpu's builder does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod


@dataclasses.dataclass
class Geometry:
    tri_v0: torch.Tensor      # (T,3)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor      # (T,3) shading normals (default: geometric)
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor     # (T,2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    pln_lo: torch.Tensor      # (P,3)
    pln_hi: torch.Tensor      # (P,3)
    pln_ax: torch.Tensor      # (P,) int32
    pln_facing: torch.Tensor  # (P,) bool
    dsk_center: torch.Tensor  # (D,3)
    dsk_normal: torch.Tensor  # (D,3) unit
    dsk_radius: torch.Tensor  # (D,)
    dsk_inner: torch.Tensor   # (D,)


@dataclasses.dataclass
class Scene:
    geom: Geometry
    prim_mat: torch.Tensor    # (N,) int32
    prim_light: torch.Tensor  # (N,) int32 (−1 none)
    materials: mat_mod.MaterialTable
    lights: Optional[lights_mod.LightTable]
    world_lo: torch.Tensor    # (3,)
    world_hi: torch.Tensor    # (3,)
    n_tri: int
    n_sph: int
    n_pln: int
    n_channels: int
    bvh: Any = None
    n_dsk: int = 0
    # fused-path kernel profile (ops/fused_path.py):
    # (axis, plane_facing, portal_facing, n_materials, mode) or None
    fused_profile: Optional[tuple] = None

    @property
    def n_prims(self) -> int:
        return self.n_tri + self.n_sph + self.n_pln + self.n_dsk

    def world_radius(self) -> torch.Tensor:
        return 0.5 * torch.linalg.norm(self.world_hi - self.world_lo) + 1e-3

    # per-ray primitive-table lookups; the index is clipped into range as
    # pbrt_tpu's fastgather.gather_rows does (a miss carries −1)
    def mat_at(self, prim_id: torch.Tensor) -> torch.Tensor:
        return self.prim_mat[prim_id.clamp(0, self.prim_mat.shape[0] - 1)]

    def light_at(self, prim_id: torch.Tensor) -> torch.Tensor:
        return self.prim_light[prim_id.clamp(0,
                                             self.prim_light.shape[0] - 1)]


def to_device(obj, device):
    """Copy every tensor of a (nested) dataclass of tensors to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def require_device(device) -> torch.device:
    """The device an entry point runs on. The port's entry points default
    to the card; they raise when asked for a CUDA device that is not
    there, and never carry on on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pbrt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run the kernels' plain-torch "
            "twins on the CPU")
    return device


def _unported(what: str, item: int):
    raise NotImplementedError(f"{what}: ROADMAP queue 1 item {item}")


class SceneBuilder:
    """Host-side scene construction (numpy lists → tensors), the role of
    the pbrt API's world block. ``spectrum_cfg``: RGB (3 channels) or
    SAMPLED (60 bins)."""

    def __init__(self, spectrum_cfg: spec_mod.SpectrumConfig = spec_mod.RGB):
        self.cfg = spectrum_cfg
        self.n_channels = spectrum_cfg.n_channels
        self.bvh_split = "sah"  # BVH SplitMethod (bvh.h:58)
        self.tris = []        # dicts: v0 v1 v2 n0 n1 n2 uv0 uv1 uv2 mat light
        self.spheres = []     # dicts: center radius mat light
        self.planes = []      # dicts: lo hi ax facing mat light
        self.disks = []       # dicts: center normal radius inner mat light
        self.materials = []   # parameter dicts (scene/materials.py)
        self.light_rows = []  # parameter dicts (scene/lights.py)

    # -- materials and lights ---------------------------------------------
    def add_material(self, **params) -> int:
        mat_mod.check_row(params)
        for key in ("kd", "ks", "kr", "kt", "metal_eta", "metal_k",
                    "scatter_d"):
            if key in params:
                params[key] = self._to_spec(params[key])
        self.materials.append(params)
        return len(self.materials) - 1

    def _to_spec(self, v):
        v = np.asarray(v, np.float32)
        if v.ndim == 0:
            return np.full(self.n_channels, float(v), np.float32)
        if v.shape[-1] == 3 and self.n_channels != 3:
            return spec_mod.from_rgb(v, self.cfg)
        if v.shape[-1] == self.n_channels:
            return v
        raise ValueError(f"bad spectrum shape {v.shape}")

    def add_light(self, **params) -> int:
        for key in ("L", "I", "scale"):
            if key in params:
                params[key] = self._to_spec(params[key])
        self.light_rows.append(params)
        return len(self.light_rows) - 1

    # -- shapes ------------------------------------------------------------
    def add_triangle(self, v0, v1, v2, mat=0, light=-1, n0=None, n1=None,
                     n2=None, uv0=(0, 0), uv1=(1, 0), uv2=(1, 1), med_in=-1,
                     med_out=-1, v0_e=None, v1_e=None, v2_e=None):
        if med_in != -1 or med_out != -1:
            _unported("participating media", 9)
        if any(x is not None for x in (v0_e, v1_e, v2_e)):
            _unported("motion blur", 8)
        self.tris.append(dict(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
                              uv0=uv0, uv1=uv1, uv2=uv2, mat=mat,
                              light=light))
        return len(self.tris) - 1

    def add_mesh(self, vertices, indices, mat=0, light=-1, normals=None,
                 uvs=None, med_in=-1, med_out=-1, vertices_end=None):
        """trianglemesh: vertices (V,3), indices (F,3)."""
        if vertices_end is not None:
            _unported("motion blur", 8)
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        ids = []
        for f in indices:
            kw = dict(med_in=med_in, med_out=med_out)
            if normals is not None:
                kw.update(n0=normals[f[0]], n1=normals[f[1]],
                          n2=normals[f[2]])
            if uvs is not None:
                kw.update(uv0=uvs[f[0]], uv1=uvs[f[1]], uv2=uvs[f[2]])
            ids.append(self.add_triangle(vertices[f[0]], vertices[f[1]],
                                         vertices[f[2]], mat, light, **kw))
        return ids

    def add_sphere(self, center, radius, mat=0, light=-1, med_in=-1,
                   med_out=-1):
        if med_in != -1 or med_out != -1:
            _unported("participating media", 9)
        self.spheres.append(dict(center=center, radius=radius, mat=mat,
                                 light=light))
        return len(self.spheres) - 1

    def add_aaplane(self, lo, hi, axis, facing_fw=True, mat=0, light=-1,
                    med_in=-1, med_out=-1):
        if med_in != -1 or med_out != -1:
            _unported("participating media", 9)
        self.planes.append(dict(lo=lo, hi=hi, ax=axis, facing=facing_fw,
                                mat=mat, light=light))
        return len(self.planes) - 1

    def add_disk(self, center, normal, radius, inner=0.0, mat=0, light=-1,
                 med_in=-1, med_out=-1):
        """shapes/disk.cpp in world space: ``normal`` is the unit normal."""
        if med_in != -1 or med_out != -1:
            _unported("participating media", 9)
        self.disks.append(dict(center=center, normal=normal, radius=radius,
                               inner=inner, mat=mat, light=light))
        return len(self.disks) - 1

    def add_curve(self, *args, **kw):
        _unported("curves", 8)

    def add_instanced_object(self, *args, **kw):
        _unported("instancing", 6)

    def add_medium(self, *args, **kw):
        _unported("participating media", 9)

    def add_texture(self, *args, **kw):
        _unported("textures", 8)

    # -- finalize ----------------------------------------------------------
    def prim_index(self, family: str, local_idx: int) -> int:
        """Global primitive index for (family, local index)."""
        nt, ns, npl = len(self.tris), len(self.spheres), len(self.planes)
        base = {"tri": 0, "sph": nt, "pln": nt + ns,
                "dsk": nt + ns + npl}[family]
        return base + local_idx

    def build(self, device="cuda", use_bvh: str = "auto") -> Scene:
        """The scene's tensors on ``device``. ``use_bvh``: "auto" builds a
        BVH over the triangles when there are more than 256 (pbrt_tpu's
        rule), "always" and "never" force it; ``self.bvh_split`` picks
        the split method."""
        if use_bvh not in ("auto", "always", "never"):
            raise ValueError(f"use_bvh={use_bvh!r}")
        device = require_device(device)
        nt, ns, npl = len(self.tris), len(self.spheres), len(self.planes)
        nd = len(self.disks)
        if any(r["light"] != -1 for r in self.disks):
            _unported("area lights on disks", 8)

        def rows_f32(rows, key, shape):
            if not rows:
                return np.zeros(shape, np.float32)
            return np.asarray([np.asarray(r[key], np.float32) for r in rows],
                              np.float32).reshape(shape)

        tv = [rows_f32(self.tris, k, (max(nt, 1), 3))
              for k in ("v0", "v1", "v2")]
        # default shading normals = geometric
        gn = np.cross(tv[1] - tv[0], tv[2] - tv[0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-12)
        tn = [np.asarray([np.asarray(r[k], np.float32) if r[k] is not None
                          else gn[i] for i, r in enumerate(self.tris)],
                         np.float32).reshape(max(nt, 1), 3) if nt else gn
              for k in ("n0", "n1", "n2")]
        tuv = [rows_f32(self.tris, k, (max(nt, 1), 2))
               for k in ("uv0", "uv1", "uv2")]
        s_c = rows_f32(self.spheres, "center", (max(ns, 1), 3))
        s_r = np.asarray([r["radius"] for r in self.spheres] or [0.0],
                         np.float32)
        p_lo = rows_f32(self.planes, "lo", (max(npl, 1), 3))
        p_hi = rows_f32(self.planes, "hi", (max(npl, 1), 3))
        d_c = rows_f32(self.disks, "center", (max(nd, 1), 3))
        d_r = np.asarray([r["radius"] for r in self.disks] or [0.0],
                         np.float32)

        def t(a):
            return torch.as_tensor(a, device=device)

        geom = Geometry(
            tri_v0=t(tv[0]), tri_v1=t(tv[1]), tri_v2=t(tv[2]),
            tri_n0=t(tn[0]), tri_n1=t(tn[1]), tri_n2=t(tn[2]),
            tri_uv0=t(tuv[0]), tri_uv1=t(tuv[1]), tri_uv2=t(tuv[2]),
            sph_center=t(s_c), sph_radius=t(s_r),
            pln_lo=t(p_lo), pln_hi=t(p_hi),
            pln_ax=t(np.asarray([r["ax"] for r in self.planes] or [2],
                                np.int32)),
            pln_facing=t(np.asarray([r["facing"] for r in self.planes]
                                    or [True], bool)),
            dsk_center=t(d_c),
            dsk_normal=t(rows_f32(self.disks, "normal", (max(nd, 1), 3))),
            dsk_radius=t(d_r),
            dsk_inner=t(np.asarray([r["inner"] for r in self.disks]
                                   or [0.0], np.float32)))

        def ids(key):
            a = np.asarray([r[key] for r in self.tris + self.spheres
                            + self.planes + self.disks], np.int32)
            return a if a.size else np.full(1, 0 if key == "mat" else -1,
                                            np.int32)

        pts = [v[:nt] for v in tv]
        if ns:
            pts += [s_c - s_r[:, None], s_c + s_r[:, None]]
        if npl:
            pts += [p_lo, p_hi]
        if nd:
            pts += [d_c - d_r[:, None], d_c + d_r[:, None]]
        allp = np.concatenate([p for p in pts if p.size]) \
            if any(p.size for p in pts) else np.zeros((1, 3), np.float32)
        world_lo, world_hi = allp.min(0) - 1e-3, allp.max(0) + 1e-3
        scene = Scene(
            geom=geom, prim_mat=t(ids("mat")), prim_light=t(ids("light")),
            materials=mat_mod.make_material_table(
                self.materials or [dict()], self.n_channels, device),
            lights=lights_mod.build_light_table(self, world_lo, world_hi,
                                                device),
            world_lo=t(world_lo), world_hi=t(world_hi),
            n_tri=nt, n_sph=ns, n_pln=npl, n_dsk=nd,
            n_channels=self.n_channels)
        if use_bvh == "always" or (use_bvh == "auto" and nt > 256):
            from pbrt_tpu_torch.scene import bvh as bvh_mod
            scene = dataclasses.replace(
                scene, bvh=bvh_mod.build_bvh(scene,
                                             split_method=self.bvh_split))
        return dataclasses.replace(scene,
                                   fused_profile=self._fused_profile(scene))

    def _fused_profile(self, scene):
        """Static profile for the fused path-bounce kernel
        (ops/fused_path.py), as pbrt_tpu's gate (types.py:567-629):
        all-matte triangles + ONE aaplane that is the scene's single
        one-sided area light, either

        - mode 1 ("projection"): a projection-strategy portal light with
          one portal parallel to the light plane, or
        - mode 0 ("area"): a plain diffuse area light (two-sample MIS).

        The kernel shades every row as matte: a row of another type, or
        with a key beyond (type, kd, sigma), or with Oren–Nayar roughness,
        rules the scene out, as in pbrt_tpu's gate. Disks are ruled out as
        there; the other families it rules out (curves, instances, motion,
        media, textures, SSS, Fourier) cannot be built here at all. A built
        BVH does not disqualify: the fused kernel reads the builder-order
        triangles and culls by its own clusters.
        The triangle cap is the kernel's shared memory plan
        (fused_path.MAX_TRI). Returns (axis, plane_facing,
        portal_facing, n_materials, mode) or None."""
        from pbrt_tpu_torch.ops.fused_path import MAX_MAT, MAX_TRI

        if scene.n_sph or scene.n_dsk:
            return None
        if scene.n_pln != 1 or scene.n_tri < 1 or scene.n_tri > MAX_TRI:
            return None
        if scene.n_channels != 3 or len(self.materials) > MAX_MAT:
            return None
        for m in self.materials:
            if set(m) - {"type", "kd", "sigma"}:
                return None
            if int(m.get("type", mat_mod.MATTE)) != mat_mod.MATTE:
                return None
            if float(np.max(np.asarray(m.get("sigma", 0.0)))) != 0.0:
                return None
        if len(self.light_rows) != 1:
            return None
        lr = self.light_rows[0]
        if lr.get("type") != "area" or lr.get("two_sided", False):
            return None
        if any(tr["light"] != -1 for tr in self.tris):
            return None
        if int(scene.lights.prim_id[0]) != scene.n_tri:
            return None
        pl = self.planes[0]
        portals = lr.get("portals") or ()
        if not portals:
            if lr.get("strategy") not in (None, "light"):
                return None
            return (int(pl["ax"]), bool(pl["facing"]), False,
                    len(self.materials), 0)
        if lr.get("strategy") != "projection" or len(portals) != 1:
            return None
        pax = int(portals[0][2])
        pfac = bool(portals[0][3])
        if int(pl["ax"]) != pax:       # SampleProj assumes parallel rects
            return None
        return (pax, bool(pl["facing"]), pfac, len(self.materials), 1)
