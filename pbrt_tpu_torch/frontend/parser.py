""".pbrt scene-description parser and scene-build state machine (port of
pbrt_tpu/frontend/parser.py).

The tokenizer and recursive parse of core/parser.cpp:98-1080 and the
pbrt* API state machine of core/api.cpp:367-1752 (the GraphicsState
attribute stack, the CTM stack, named materials, the Make* factories),
driving the port's ``SceneBuilder``. Host side, numpy only: the current
transformation matrix is float64 until ``build`` rounds the tables to
float32, and every table the builder receives is the one pbrt_tpu's
parser hands its own builder, so both packages build the same scene from
one file.

Textures (``Texture`` and a textured Kd), media (``MakeNamedMedium``,
``MediumInterface``, the null material ``""`` / ``none``) and object
instancing (``ObjectBegin`` / ``ObjectEnd`` / ``ObjectInstance``: true
instances of pure triangle-mesh objects, flattened copies of any other)
are read as pbrt_tpu reads them, and so are the subsurface, kdsubsurface
(``SubsurfaceFromDiffuse`` through scene/bssrdf.py) and Disney
scatterdistance materials, the ``hair`` material (its absorption from
``sigma_a``, else ``color``, else the melanin concentrations) and
``fourier`` (its ``bsdffile`` relative to the scene file), and the
``curve`` shape (control points to world space, widths scaled by the
CTM's mean scale, a ribbon's normals through the inverse transpose; only
the first four control points, as pbrt_tpu reads them). Everything
pbrt_tpu's parser reads and the port cannot build yet raises
``NotImplementedError`` naming its ROADMAP queue 1 item, at the directive
that asks for it: emissive disks. ``Accelerator "kdtree"`` over more
than 256 triangles makes a kd-tree the scene's aggregate
(scene/kdtree.py), as pbrt_tpu's parser does. Motion blur is read
as pbrt_tpu reads it: ``ActiveTransform`` picks which of the two CTMs
(shutter start and end) a directive changes, a ``trianglemesh`` under
differing CTMs gets shutter-end vertices (an emissive one stays at the
start, as in pbrt_tpu), and differing CTMs at ``Camera`` make an
animated camera over ``TransformTimes`` (default 0 to 1). A
``spectrum_cfg`` of SAMPLED builds a 60-bin scene
as pbrt_tpu's does: each spectrum-typed parameter resolves to RGB first
(``Params.spectrum_rgb``) and the builder lifts it to 60 bins
(``from_rgb``); the reference binary keeps an SPD as it is. An
integrator keyword the port lacks raises when the scene is rendered, so
``--cat`` still reads such a file. What pbrt_tpu's parser itself skips,
or records and never reads (unknown directives, shapes, light types and
parameters, ReverseOrientation), is skipped here too.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.core import transform as tr
from pbrt_tpu_torch.frontend.sexpr import parse_portal_data
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import tessellate as tess
from pbrt_tpu_torch.scene.types import SceneBuilder, _unported
from pbrt_tpu_torch.utils import imageio


# ---------------------------------------------------------------------------
# tokenizer (core/parser.cpp:98-203)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')


def tokenize(text: str):
    for m in _TOKEN_RE.finditer(text):
        t = m.group(0)
        if not t.startswith("#"):
            yield t


# ---------------------------------------------------------------------------
# ParamSet parsing (core/paramset.cpp ParseParams)
# ---------------------------------------------------------------------------

_PARAM_TYPES = {"integer", "float", "bool", "string", "point", "point3",
                "point2", "vector", "vector3", "normal", "rgb", "color",
                "spectrum", "texture", "blackbody", "xyz"}


def _convert(ptype: str, vals):
    # tolerate trailing commas in numeric lists (a Blender exporter
    # artifact the reference's std::stof accepts)
    vals = [v.rstrip(",") if isinstance(v, str) else v for v in vals]
    if ptype == "integer":
        return np.asarray([int(float(v)) for v in vals], np.int64)
    if ptype == "float":
        return np.asarray([float(v) for v in vals], np.float64)
    if ptype == "bool":
        return [v.strip('"') == "true" for v in vals]
    if ptype in ("string", "texture"):
        return [v.strip('"') for v in vals]
    if ptype == "spectrum" and vals and isinstance(vals[0], str) \
            and vals[0].startswith('"'):
        # an on-disk SPD: "spectrum Kd" "metal-Cu.spd" (resolved in
        # spectrum_rgb against the scene file's directory)
        return [v.strip('"') for v in vals]
    return np.asarray([float(v) for v in vals], np.float64)


class Params(dict):
    """Typed parameter bag (core/paramset.h:53 FindOne* semantics)."""

    def __init__(self, base_dir="."):
        super().__init__()
        self.base_dir = base_dir

    def one(self, name, default=None):
        if name not in self:
            return default
        ptype, vals = self[name]
        if ptype in ("string", "texture", "bool"):
            return vals[0]
        if ptype == "integer":
            return int(vals[0])
        if ptype == "float":
            return float(vals[0])
        return vals

    def point(self, name, default=None):
        if name not in self:
            return default
        return tuple(np.asarray(self[name][1], np.float64).reshape(-1)[:3])

    def spectrum_rgb(self, name, default=None):
        """Any spectrum-typed parameter as linear RGB."""
        if name not in self:
            return default
        ptype, vals = self[name]
        if ptype == "spectrum" and len(vals) and isinstance(vals[0], str):
            from pbrt_tpu_torch.utils.floatfile import read_float_file
            path = vals[0] if os.path.isabs(vals[0]) \
                else os.path.join(self.base_dir, vals[0])
            vals = np.asarray(read_float_file(path), np.float64)
        a = np.asarray(vals, np.float64).reshape(-1)
        if ptype in ("rgb", "color"):
            return tuple(a[:3])
        if ptype == "spectrum":
            pairs = a.reshape(-1, 2)
            return tuple(spec_mod.spd_from_pairs(pairs[:, 0], pairs[:, 1]))
        if ptype == "blackbody":
            s = spec_mod.blackbody_normalized(spec_mod.bin_centers(), a[0])
            scale = a[1] if len(a) > 1 else 1.0
            return tuple(spec_mod.spectrum_to_rgb(s * scale))
        if ptype == "float":
            return (a[0], a[0], a[0])
        if ptype == "xyz":
            return tuple(spec_mod.xyz_to_rgb(a[:3]))
        return tuple(a[:3])


def parse_params(tokens, peeked, base_dir=".") -> Params:
    """Consume '"type name" [values...]' pairs until a non-param token."""
    params = Params(base_dir)
    while True:
        t = peeked[0] if peeked else next(tokens, None)
        peeked.clear()
        if t is None:
            break
        if not (t.startswith('"') and len(t.split()) == 2
                and t.strip('"').split()[0] in _PARAM_TYPES):
            peeked.append(t)
            break
        ptype, name = t.strip('"').split()
        nxt = next(tokens)
        vals = []
        if nxt == "[":
            for v in tokens:
                if v == "]":
                    break
                vals.append(v)
        else:
            vals.append(nxt)
        params[name] = (ptype, _convert(ptype, vals))
    return params


# ---------------------------------------------------------------------------
# graphics state (core/api.cpp:207 GraphicsState + the CTM stack)
# ---------------------------------------------------------------------------

@dataclass
class GraphicsState:
    material_id: int = 0
    area_light: Optional[dict] = None
    named_materials: dict = field(default_factory=dict)
    textures: dict = field(default_factory=dict)  # name → (class, params)
    # MediumInterface (api.cpp pbrtMediumInterface): medium ids, −1 vacuum
    medium_in: int = -1
    medium_out: int = -1


_INTEGRATORS = {"path": "path", "directlighting": "direct",
                "whitted": "whitted", "ambientocclusion": "ao",
                "mypath": "mypath", "hero_path": "hero_path",
                "hero_path_mis": "hero_path_mis", "volpath": "volpath",
                "bdpt": "bdpt", "mlt": "mlt", "sppm": "sppm",
                "hero": "hero_path"}

# material keywords → types (pbrt_tpu's parser); any other name is matte
_MATERIALS = {"matte": mat_mod.MATTE, "mirror": mat_mod.MIRROR,
              "glass": mat_mod.GLASS, "plastic": mat_mod.PLASTIC,
              "metal": mat_mod.METAL,
              "dispersive_glass": mat_mod.DISPERSIVE_GLASS,
              "uber": mat_mod.UBER, "substrate": mat_mod.SUBSTRATE,
              "translucent": mat_mod.TRANSLUCENT, "disney": mat_mod.DISNEY,
              "subsurface": mat_mod.SUBSURFACE,
              "kdsubsurface": mat_mod.SUBSURFACE,
              "hair": mat_mod.HAIR, "fourier": mat_mod.FOURIER,
              "none": mat_mod.NONE, "": mat_mod.NONE}
# Texture classes → scene/textures.py types
_TEXTURES = {"constant": 0, "scale": 1, "mix": 2, "checkerboard": 3,
             "uv": 4, "dots": 5, "bilerp": 6, "imagemap": 7, "fbm": 8,
             "wrinkled": 9, "windy": 10, "marble": 11}
# Disney parameter → row key (materials/disney.cpp)
_DISNEY_PARAMS = (("metallic", "metallic"), ("speculartint", "spec_tint"),
                  ("sheen", "sheen"), ("sheentint", "sheen_tint"),
                  ("clearcoat", "clearcoat"),
                  ("clearcoatgloss", "clearcoat_gloss"), ("eta", "eta"),
                  ("anisotropic", "anisotropic"),
                  ("spectrans", "spec_trans"), ("difftrans", "diff_trans"),
                  ("flatness", "flatness"))


class PbrtParser:
    def __init__(self, spectrum_cfg=spec_mod.RGB, base_dir="."):
        self.builder = SceneBuilder(spectrum_cfg)
        self.base_dir = base_dir
        self.ctm = np.eye(4)
        self.ctm2 = np.eye(4)          # end-time CTM (TransformSet[1])
        self.active = (True, True)     # pbrtActiveTransformAll default
        self.ctm_stack = []
        self.gs = GraphicsState()
        self.gs_stack = []
        self.world = False
        self.options = {
            "integrator": "path", "integrator_params": Params(base_dir),
            "sampler": "halton", "spp": 16,
            "film": {"xres": 640, "yres": 480, "filename": "out.exr"},
            "filter": ("box", {}),
            "camera": ("perspective", Params(base_dir)),
            "camera_to_world": np.eye(4),
        }
        self.object_defs = {}        # ObjectBegin name → recorded shapes
        self.recording = None
        self._instance_obj_ids = {}  # name → the builder's object id
        self.named_media = {}        # MakeNamedMedium name → medium id
        self._tex_ids = {}           # Texture name → texture row
        # the default material (api.cpp: matte)
        self.builder.add_material(type=mat_mod.MATTE, kd=0.5)

    def _params(self, tokens, peeked) -> Params:
        return parse_params(tokens, peeked, self.base_dir)

    # -- transforms --------------------------------------------------------

    def _apply(self, m):
        # pbrt keeps two CTMs (start and end time, api.cpp TransformSet);
        # ActiveTransform selects which ones a directive changes
        if self.active[0]:
            self.ctm = self.ctm @ m
        if self.active[1]:
            self.ctm2 = self.ctm2 @ m

    def _set(self, m):
        if self.active[0]:
            self.ctm = m.copy()
        if self.active[1]:
            self.ctm2 = m.copy()

    @property
    def animated(self) -> bool:
        return not np.allclose(self.ctm, self.ctm2)

    def _xf_point(self, p):
        v = self.ctm @ np.append(np.asarray(p, np.float64), 1.0)
        return tuple(v[:3] / v[3])

    def _xf_points(self, pts, ctm=None):
        """Points through the CTM, or through ``ctm`` (the end CTM)."""
        m = self.ctm if ctm is None else ctm
        out = []
        for q in pts:
            v = m @ np.append(np.asarray(q, np.float64), 1.0)
            out.append(tuple(v[:3] / v[3]))
        return np.stack(out)

    def _xf_vec(self, p):
        return tuple(self.ctm[:3, :3] @ np.asarray(p, np.float64))

    def _xf_normals(self, ns):
        """Normals through the inverse transpose of the CTM."""
        inv_t = np.linalg.inv(self.ctm[:3, :3]).T
        return np.stack([tuple(inv_t @ np.asarray(n, np.float64))
                         for n in ns])

    # -- directive dispatch ------------------------------------------------

    def parse(self, text: str):
        tokens = tokenize(text)
        peeked = []

        def nxt():
            if peeked:
                return peeked.pop()
            return next(tokens, None)

        while True:
            t = nxt()
            if t is None:
                break
            handler = getattr(self, "_d_" + t, None)
            if handler is not None:   # unknown tokens are skipped
                handler(tokens, peeked, nxt)
        return self

    # directives ----------------------------------------------------------

    def _d_Include(self, tokens, peeked, nxt):
        path = os.path.join(self.base_dir, nxt().strip('"'))
        with open(path) as f:
            text = f.read()
        sub = PbrtParser.__new__(PbrtParser)
        sub.__dict__ = self.__dict__  # share all state
        sub.parse(text)

    def _d_LookAt(self, tokens, peeked, nxt):
        v = [float(nxt()) for _ in range(9)]
        m = tr.look_at_matrix(v[0:3], v[3:6], v[6:9]).astype(np.float32)
        # the CTM takes world-to-camera (api.cpp pbrtLookAt)
        self._apply(np.linalg.inv(m.astype(np.float64)))

    def _d_Translate(self, tokens, peeked, nxt):
        m = np.eye(4)
        m[:3, 3] = [float(nxt()) for _ in range(3)]
        self._apply(m)

    def _d_Scale(self, tokens, peeked, nxt):
        self._apply(np.diag([float(nxt()) for _ in range(3)] + [1.0]))

    def _d_Rotate(self, tokens, peeked, nxt):
        ang = float(nxt())
        ax = [float(nxt()) for _ in range(3)]
        self._apply(tr.rotate_matrix(ang, ax).astype(np.float64))

    def _d_Transform(self, tokens, peeked, nxt):
        vals = self._matrix_vals(tokens, nxt)
        self._set(np.asarray(vals, np.float64).reshape(4, 4).T)

    def _d_ConcatTransform(self, tokens, peeked, nxt):
        vals = self._matrix_vals(tokens, nxt)
        self._apply(np.asarray(vals, np.float64).reshape(4, 4).T)

    def _d_Identity(self, tokens, peeked, nxt):
        self._set(np.eye(4))

    def _d_ActiveTransform(self, tokens, peeked, nxt):
        """pbrtActiveTransform{All,StartTime,EndTime}
        (core/parser.cpp:867-875)."""
        which = nxt().strip('"')
        self.active = {"All": (True, True), "StartTime": (True, False),
                       "EndTime": (False, True)}.get(which, (True, True))

    def _d_TransformTimes(self, tokens, peeked, nxt):
        """pbrtTransformTimes (core/api.cpp): the times of the two CTMs,
        which an animated camera interpolates between."""
        t0 = float(nxt())
        t1 = float(nxt())
        self.options["transform_times"] = (t0, t1)

    def _matrix_vals(self, tokens, nxt):
        t = nxt()
        vals = []
        if t == "[":
            for v in tokens:
                if v == "]":
                    break
                vals.append(float(v))
        else:
            vals.append(float(t))
            for _ in range(15):
                vals.append(float(next(tokens)))
        return vals

    def _d_Camera(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        params = self._params(tokens, peeked)
        # camera-to-world = inverse(CTM) (api.cpp pbrtCamera), at both
        # shutter ends
        self.options["camera"] = (name, params)
        self.options["camera_to_world"] = np.linalg.inv(self.ctm)
        self.options["camera_to_world_end"] = np.linalg.inv(self.ctm2)

    def _d_Film(self, tokens, peeked, nxt):
        nxt()  # "image"
        p = self._params(tokens, peeked)
        self.options["film"] = {
            "xres": p.one("xresolution", 640),
            "yres": p.one("yresolution", 480),
            "filename": p.one("filename", "out.exr")}
        if "cropwindow" in p:
            cw = np.asarray(p["cropwindow"][1], np.float64).reshape(-1)[:4]
            self.options["film"]["crop"] = tuple(cw)

    def _d_Sampler(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        self.options["sampler"] = name
        self.options["spp"] = p.one("pixelsamples", 16)

    def _d_PixelFilter(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        kw = {}
        if p.one("xwidth") is not None:
            kw["xwidth"] = p.one("xwidth")
        if p.one("ywidth") is not None:
            kw["ywidth"] = p.one("ywidth")
        self.options["filter"] = (name, kw)

    def _d_Integrator(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self.options["integrator"] = name
        self.options["integrator_params"] = self._params(tokens, peeked)

    def _d_Accelerator(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        self.options["accelerator"] = name  # "bvh" (default) | "kdtree"
        sm = p.one("splitmethod")
        if sm:
            # BVHAccel "string splitmethod" sah|middle|equal|hlbvh
            self.builder.bvh_split = str(sm).strip('"')

    def _d_WorldBegin(self, tokens, peeked, nxt):
        self.world = True
        self.ctm = np.eye(4)
        self.ctm2 = np.eye(4)
        self.active = (True, True)

    def _d_WorldEnd(self, tokens, peeked, nxt):
        pass

    def _d_AttributeBegin(self, tokens, peeked, nxt):
        self.gs_stack.append(copy.deepcopy(self.gs))
        self.ctm_stack.append((self.ctm.copy(), self.ctm2.copy(),
                               self.active))

    def _d_AttributeEnd(self, tokens, peeked, nxt):
        self.gs = self.gs_stack.pop()
        self.ctm, self.ctm2, self.active = self.ctm_stack.pop()

    def _d_TransformBegin(self, tokens, peeked, nxt):
        # pbrtTransformBegin (api.cpp) saves the CTM only: material and
        # light state set inside the block persists past the End
        self.ctm_stack.append((self.ctm.copy(), self.ctm2.copy(),
                               self.active))

    def _d_TransformEnd(self, tokens, peeked, nxt):
        self.ctm, self.ctm2, self.active = self.ctm_stack.pop()

    def _d_ObjectBegin(self, tokens, peeked, nxt):
        self._d_AttributeBegin(tokens, peeked, nxt)
        self.recording = nxt().strip('"')
        self.object_defs[self.recording] = []

    def _d_ObjectEnd(self, tokens, peeked, nxt):
        self.recording = None
        self._d_AttributeEnd(tokens, peeked, nxt)

    def _d_ObjectInstance(self, tokens, peeked, nxt):
        """True instancing (TransformedPrimitive, core/primitive.h:92) of
        an object made only of triangle meshes without area lights or
        media: its geometry goes into the shared pool once, each instance
        adds its CTM. Any other object is flattened into copies."""
        name = nxt().strip('"')
        entries = self.object_defs.get(name, [])
        if self._instanceable(entries):
            if name not in self._instance_obj_ids:
                oid = self.builder.add_instanced_object()
                for entry in entries:
                    p = entry["params"]
                    idx = np.asarray(p["indices"][1],
                                     np.int32).reshape(-1, 3)
                    pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                    m = entry["ctm"]
                    pts_o = (pts @ m[:3, :3].T + m[:3, 3]).astype(
                        np.float32)
                    uvs = None
                    for uk in ("st", "uv"):
                        if uk in p:
                            uvs = np.asarray(p[uk][1],
                                             np.float64).reshape(-1, 2)
                    normals = None
                    if "N" in p:
                        # into the pool's space by the recorded CTM's
                        # inverse-transpose (core/transform.h)
                        ns = np.asarray(p["N"][1],
                                        np.float64).reshape(-1, 3)
                        normals = (ns @ np.linalg.inv(m[:3, :3])).astype(
                            np.float32)
                    self.builder.add_object_mesh(
                        oid, pts_o, idx, mat=entry["gs"].material_id,
                        uvs=uvs, normals=normals)
                self._instance_obj_ids[name] = oid
            self.builder.add_instance(self._instance_obj_ids[name],
                                      self.ctm)
            return
        for entry in entries:
            # both CTMs compose with the recorded one (pbrt_tpu composes
            # the start CTM only, which its builder then reads as motion)
            saved = self.ctm, self.ctm2
            self.ctm = self.ctm @ entry["ctm"]
            self.ctm2 = self.ctm2 @ entry["ctm"]
            self._emit_shape(entry["name"], entry["params"], entry["gs"])
            self.ctm, self.ctm2 = saved

    @staticmethod
    def _instanceable(entries) -> bool:
        return bool(entries) and all(
            e["name"] == "trianglemesh" and e["gs"].area_light is None
            and e["gs"].medium_in == -1 and e["gs"].medium_out == -1
            for e in entries)

    def _d_Texture(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        nxt()                       # the value type: spectrum or float
        klass = nxt().strip('"')
        self.gs.textures[name] = (klass, self._params(tokens, peeked))

    def _d_MakeNamedMedium(self, tokens, peeked, nxt):
        """MakeNamedMedium (api.cpp pbrtMakeNamedMedium → MakeMedium,
        media/homogeneous.cpp and media/grid.cpp)."""
        from pbrt_tpu_torch.scene import media as media_mod
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        C = self.builder.n_channels
        scale = p.one("scale", 1.0)
        sa = np.asarray(p.spectrum_rgb("sigma_a", (1.0, 1.0, 1.0)),
                        np.float32) * scale
        ss = np.asarray(p.spectrum_rgb("sigma_s", (1.0, 1.0, 1.0)),
                        np.float32) * scale
        g = p.one("g", 0.0)
        if p.one("type", "homogeneous") == "heterogeneous" \
                and "density" in p:
            nx, ny, nz = (int(p.one("nx", 1)), int(p.one("ny", 1)),
                          int(p.one("nz", 1)))
            dens = np.asarray(p["density"][1], np.float32).reshape(nz, ny,
                                                                   nx)
            p0 = self._xf_point(p.point("p0", (0, 0, 0)))
            p1 = self._xf_point(p.point("p1", (1, 1, 1)))
            med = media_mod.make_grid(sa, ss, dens, np.minimum(p0, p1),
                                      np.maximum(p0, p1), g, C)
        else:
            med = media_mod.make_homogeneous(sa, ss, g, C)
        self.named_media[name] = self.builder.add_medium(med)

    def _d_MediumInterface(self, tokens, peeked, nxt):
        """MediumInterface "inside" ["outside"] (api.cpp
        pbrtMediumInterface). Before WorldBegin it sets the camera's
        medium; an unknown name is vacuum."""
        inside = nxt().strip('"')
        outside = ""
        t = nxt()
        if t is not None and t.startswith('"'):
            outside = t.strip('"')
        elif t is not None:
            peeked.append(t)
        mi = self.named_media.get(inside, -1)
        if not self.world:
            self.builder.camera_med = mi
        else:
            self.gs.medium_in = mi
            self.gs.medium_out = self.named_media.get(outside, -1)

    def _d_Material(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self.gs.material_id = self._make_material(
            name, self._params(tokens, peeked))

    def _d_MakeNamedMaterial(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        self.gs.named_materials[name] = self._make_material(
            p.one("type", "matte"), p)

    def _d_NamedMaterial(self, tokens, peeked, nxt):
        self.gs.material_id = self.gs.named_materials.get(
            nxt().strip('"'), 0)

    def _d_LightSource(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = self._params(tokens, peeked)
        b = self.builder
        scale = p.spectrum_rgb("scale", (1.0, 1.0, 1.0))
        if name == "point":
            b.add_light(type="point", I=p.spectrum_rgb("I", (1, 1, 1)),
                        scale=scale,
                        pos=self._xf_point(p.point("from", (0, 0, 0))))
        elif name == "spot":
            frm = p.point("from", (0, 0, 0))
            to = p.point("to", (0, 0, 1))
            d = np.asarray(self._xf_point(to)) - np.asarray(
                self._xf_point(frm))
            b.add_light(type="spot", I=p.spectrum_rgb("I", (1, 1, 1)),
                        scale=scale, pos=self._xf_point(frm), dir=tuple(d),
                        cone_angle=p.one("coneangle", 30.0),
                        cone_delta=p.one("conedeltaangle", 5.0))
        elif name == "distant":
            frm = np.asarray(p.point("from", (0, 0, 0)))
            to = np.asarray(p.point("to", (0, 0, 1)))
            b.add_light(type="distant", L=p.spectrum_rgb("L", (1, 1, 1)),
                        scale=scale, dir=tuple(self._xf_vec(to - frm)))
        elif name in ("goniometric", "projection"):
            kw = dict(type=name, I=p.spectrum_rgb("I", (1, 1, 1)),
                      scale=scale, pos=self._xf_point((0, 0, 0)),
                      dir=self._xf_vec((0, 0, 1)))
            if p.one("mapname"):
                # pbrt_tpu reads the map where it can and else leaves it
                # out (a constant map)
                try:
                    kw["map"] = imageio.read_image(
                        os.path.join(self.base_dir, p.one("mapname")))
                except (OSError, ValueError):
                    pass
            if name == "projection":
                kw["fov"] = p.one("fov", 45.0)
            b.add_light(**kw)
        elif name in ("infinite", "exinfinite"):
            mapname = p.one("mapname")
            b.add_light(type="infinite", L=p.spectrum_rgb("L", (1, 1, 1)),
                        scale=scale, env_map=imageio.read_image(
                            os.path.join(self.base_dir, mapname))
                        if mapname else np.ones((1, 1, 3), np.float32))

    def _d_AreaLightSource(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self.gs.area_light = {"kind": name,
                              "params": self._params(tokens, peeked)}

    def _d_Shape(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        params = self._params(tokens, peeked)
        if self.recording is not None:
            self.object_defs[self.recording].append(dict(
                name=name, params=params, ctm=self.ctm.copy(),
                gs=copy.deepcopy(self.gs)))
            return
        self._emit_shape(name, params, self.gs)

    # -- construction helpers ---------------------------------------------

    def _build_texture(self, name: str) -> int:
        """A named texture (Texture directive) as a row of the builder's
        texture table; −1 for an unknown name. Texture operands (scale.cpp
        :44-48) become rows too, recursively."""
        if name in self._tex_ids:
            return self._tex_ids[name]
        if name not in self.gs.textures:
            return -1
        klass, p = self.gs.textures[name]
        kw = dict(type=_TEXTURES.get(klass, 0))
        self._tex_ids[name] = -1    # a cyclic operand reads as unknown
        for pname, slot, op_slot in (("tex1", "v1", "op1"),
                                     ("tex2", "v2", "op2"),
                                     ("value", "v1", "op1")):
            if pname in p and p[pname][0] == "texture":
                kw[op_slot] = self._build_texture(p.one(pname))
                continue
            v = p.spectrum_rgb(pname)
            if v is not None:
                kw[slot] = v
        for pname in ("uscale", "vscale", "udelta", "vdelta", "octaves",
                      "omega", "variation"):
            if p.one(pname) is not None:
                kw[pname] = p.one(pname)
        # the noise textures' names (marble.cpp): roughness → omega,
        # scale → the 3D noise frequency
        if p.one("roughness") is not None:
            kw["omega"] = p.one("roughness")
        if p.one("scale") is not None and klass in ("marble", "fbm",
                                                    "wrinkled", "windy"):
            kw["scale3d"] = p.one("scale")
        if "amount" in p:
            if p["amount"][0] == "texture":
                kw["op3"] = self._build_texture(p.one("amount"))
            else:
                kw["omega"] = p.one("amount")   # a mix's amount
        if klass == "imagemap" and p.one("filename"):
            try:
                img = imageio.read_image(os.path.join(self.base_dir,
                                                      p.one("filename")))
                kw["img"] = self.builder.add_image(img)
                # pbrt's imagemap filters with EWA unless "bool trilinear"
                # (textures/imagemap.cpp)
                if not p.one("trilinear"):
                    self.builder.tex_filtering = "ewa"
            except (OSError, ValueError):
                # an unreadable image: pbrt_tpu's constant 0.5 instead
                kw["type"] = 0
                kw["v1"] = (0.5, 0.5, 0.5)
        tid = self.builder.add_texture(**kw)
        self._tex_ids[name] = tid
        return tid

    def _make_material(self, name: str, p: Params) -> int:
        b = self.builder
        if name == "mix":
            # materials/mixmat.cpp, resolved at build time: two rows of one
            # type blend parameter-wise by `amount`; of two types, the
            # dominant row stays with its kd scaled by max(amt, 1 - amt)
            m1 = self.gs.named_materials.get(p.one("namedmaterial1", ""), 0)
            m2 = self.gs.named_materials.get(p.one("namedmaterial2", ""), 0)
            amt_s = float(np.mean(p.spectrum_rgb("amount", (0.5, 0.5, 0.5))))
            r1, r2 = b.materials[m1], b.materials[m2]
            if r1.get("type", 0) == r2.get("type", 0):
                out = dict(r1)
                for key in set(r1) | set(r2):
                    if key not in ("type", "kd_tex"):
                        out[key] = (amt_s * np.asarray(r1.get(key, 0.0),
                                                       np.float64)
                                    + (1 - amt_s)
                                    * np.asarray(r2.get(key, 0.0),
                                                 np.float64))
                return b.add_material(**out)
            out = dict(r1 if amt_s >= 0.5 else r2)
            if "kd" in out:
                out["kd"] = np.asarray(out["kd"], np.float64) \
                    * max(amt_s, 1 - amt_s)
            return b.add_material(**out)
        kw = dict(type=_MATERIALS.get(name, mat_mod.MATTE))
        if "Kd" in p and p["Kd"][0] == "texture":
            kw["kd_tex"] = self._build_texture(p["Kd"][1][0])
        for pname, key in (("Kd", "kd"), ("Ks", "ks"), ("Kr", "kr"),
                           ("Kt", "kt")):
            if pname == "Kd" and "kd_tex" in kw:
                continue
            if p.spectrum_rgb(pname) is not None:
                kw[key] = p.spectrum_rgb(pname)
        if p.one("sigma") is not None:
            kw["sigma"] = p.one("sigma")
        if p.one("roughness") is not None:
            kw["roughness"] = p.one("roughness")
        elif name == "metal":
            kw["roughness"] = 0.01   # metal.cpp's default
        elif name in ("plastic", "substrate", "uber", "disney"):
            kw["roughness"] = 0.1
        # "string distribution" "beckmann": pbrt_tpu's extension exposing
        # the Beckmann NDF (core/microfacet.h:48-105) to the scene language
        if str(p.one("distribution") or p.one("microfacetdistribution")
               or "").lower() == "beckmann":
            kw["ndf"] = mat_mod.NDF_BECKMANN
        if p.one("index") is not None:
            kw["eta"] = p.one("index")
        if p.one("eta") is not None and name == "glass":
            kw["eta"] = p.one("eta")
        if name == "metal":
            for pname, key in (("eta", "metal_eta"), ("k", "metal_k")):
                if p.spectrum_rgb(pname) is not None:
                    kw[key] = p.spectrum_rgb(pname)
        if name == "disney":
            if p.spectrum_rgb("color") is not None:
                kw["kd"] = p.spectrum_rgb("color")
            for pname, key in _DISNEY_PARAMS:
                if p.one(pname) is not None:
                    kw[key] = p.one(pname)
            if p.one("thin"):
                kw["thin"] = 1.0
            sd = p.spectrum_rgb("scatterdistance")
            # a thin surface ignores scatterdistance (disney.cpp:506-517)
            if sd is not None and float(np.max(np.asarray(sd))) > 0 \
                    and not kw.get("thin"):
                kw["scatter_d"] = tuple(np.asarray(sd, np.float64))
        if name == "dispersive_glass":
            # Cauchy from the (etaMin, etaMax) endpoints
            # (materials/dispersive_glass.cpp:62-64); the hero integrators
            # evaluate eta(λ), the others smooth glass at eta(0.55 µm)
            eta_min = p.one("etaMin", 1.5)
            eta_max = p.one("etaMax", 1.6)
            l_min = spec_mod.LAMBDA_START * 1e-3
            l_max = spec_mod.LAMBDA_END * 1e-3
            cc = (eta_max - eta_min) / (1.0 / (l_min * l_min)
                                        - 1.0 / (l_max * l_max))
            bb = eta_min - cc / (l_max * l_max)
            kw.update(cauchy_b=bb, cauchy_c=cc, eta=bb + cc / (0.55 * 0.55))
        if name == "subsurface":
            # CreateSubsurfaceMaterial's defaults as pbrt_tpu reads them
            # (materials/subsurface.cpp:120-121)
            scale_p = p.one("scale", 1.0)
            sa = p.spectrum_rgb("sigma_a", (0.0011, 0.0024, 0.014))
            ss = p.spectrum_rgb("sigma_s",
                                p.spectrum_rgb("sigma_prime_s",
                                               (2.55, 3.21, 3.77)))
            kw["sss_sigma_a"] = tuple(np.asarray(sa) * scale_p)
            kw["sss_sigma_s"] = tuple(np.asarray(ss) * scale_p)
            kw["sss_g"] = p.one("g", 0.0)
            kw["eta"] = p.one("eta", 1.33)
        if name == "kdsubsurface":
            # materials/kdsubsurface.cpp: a diffuse color and a mean free
            # path, inverted through the beam-diffusion table
            # (SubsurfaceFromDiffuse, core/bssrdf.cpp:174-184)
            from pbrt_tpu_torch.scene import bssrdf as bssrdf_mod
            kd_v = np.asarray(p.spectrum_rgb("Kd", (0.5, 0.5, 0.5)))
            # mfp is a spectrum texture parameter (kdsubsurface.cpp:
            # 104-105) and pbrt ignores a "float mfp"; pbrt_tpu honours it
            # and warns
            if "mfp" in p and p["mfp"][0] == "float":
                import sys
                print("pbrt_tpu_torch: warning: \"float mfp\" is honored "
                      "here, but pbrt IGNORES it (mfp is a spectrum "
                      "texture param) — use \"rgb mfp\" for parity",
                      file=sys.stderr)
            mfp = np.asarray(p.spectrum_rgb("mfp", p.one("mfp", 1.0))) \
                * p.one("scale", 1.0)
            g_p = p.one("g", 0.0)
            eta_p = p.one("eta", 1.33)
            sa, ss = bssrdf_mod.subsurface_from_diffuse(
                np.clip(kd_v, 0.0, 1.0), mfp, g_p, eta_p)
            kw["sss_sigma_a"] = tuple(sa)
            kw["sss_sigma_s"] = tuple(ss)
            kw["sss_g"] = g_p
            kw["eta"] = eta_p
        if name == "hair":
            self._hair_row(p, kw)
        if name == "fourier":
            fn = p.one("bsdffile", "")
            kw["fourier_id"] = b.add_fourier_table(
                fn if os.path.isabs(fn) else os.path.join(self.base_dir, fn))
        return b.add_material(**kw)

    @staticmethod
    def _hair_row(p, kw):
        """materials/hair.cpp CreateHairMaterial: the absorption from
        sigma_a, else color, else the eumelanin / pheomelanin
        concentrations (1.3 eumelanin by default)."""
        from pbrt_tpu_torch.scene import hair as hair_mod
        bn = p.one("beta_n", 0.3)
        if p.spectrum_rgb("sigma_a") is not None:
            sa = np.asarray(p.spectrum_rgb("sigma_a"))
        elif p.spectrum_rgb("color") is not None:
            sa = hair_mod.sigma_a_from_reflectance(
                np.asarray(p.spectrum_rgb("color"), np.float32), bn).numpy()
        elif p.one("eumelanin") is not None \
                or p.one("pheomelanin") is not None:
            sa = hair_mod.sigma_a_from_concentration(
                p.one("eumelanin", 1.3), p.one("pheomelanin", 0.0)).numpy()
        else:
            sa = hair_mod.sigma_a_from_concentration(1.3, 0.0).numpy()
        kw.update(sss_sigma_a=tuple(np.asarray(sa, np.float64)),
                  beta_m=p.one("beta_m", 0.3), beta_n=bn,
                  hair_alpha=p.one("alpha", 2.0), eta=p.one("eta", 1.55))

    def _area_light(self, gs):
        """A light row for an AreaLightSource bound to one primitive."""
        p = gs.area_light["params"]
        kw = dict(type="area",
                  L=p.spectrum_rgb("L", (1, 1, 1)),
                  scale=p.spectrum_rgb("scale", (1, 1, 1)),
                  two_sided=(p.one("twosided", "false") in (True, "true")),
                  prim=-1)
        if gs.area_light["kind"] == "portal":
            kw["strategy"] = p.one("strategy", "light")
            pd = p.one("portalData", "")
            kw["portals"] = parse_portal_data(pd) if pd else []
        return self.builder.add_light(**kw)

    def _emit_shape(self, name, p: Params, gs: GraphicsState):
        """A shape's rows, stamped with the attribute stack's
        MediumInterface (GeometricPrimitive's mediumInterface)."""
        b = self.builder
        families = (b.tris, b.spheres, b.planes, b.disks)
        marks = [len(rows) for rows in families]
        self._emit_shape_rows(name, p, gs)
        if gs.medium_in != -1 or gs.medium_out != -1:
            for rows, m in zip(families, marks):
                for r in rows[m:]:
                    r["med_in"] = gs.medium_in
                    r["med_out"] = gs.medium_out

    def _emit_shape_rows(self, name, p: Params, gs: GraphicsState):
        b = self.builder
        mat = gs.material_id
        if name == "trianglemesh":
            idx = np.asarray(p["indices"][1], np.int32).reshape(-1, 3)
            pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            pts_w = self._xf_points(pts)
            # an animated shape transform: the vertices at the shutter end
            # (TransformedPrimitive + AnimatedTransform, api.cpp:1414)
            pts_w_end = (self._xf_points(pts, self.ctm2) if self.animated
                         else None)
            normals = None
            if "N" in p:
                normals = self._xf_normals(
                    np.asarray(p["N"][1], np.float64).reshape(-1, 3))
            uvs = None
            for uk in ("st", "uv"):
                if uk in p:
                    uvs = np.asarray(p[uk][1], np.float64).reshape(-1, 2)
            if gs.area_light is None:
                b.add_mesh(pts_w, idx, mat=mat, light=-1, normals=normals,
                           uvs=uvs, vertices_end=pts_w_end)
                return
            # one light row per triangle (pbrt: one DiffuseAreaLight per
            # Triangle shape)
            for f in idx:
                li = self._area_light(gs)
                tid = b.add_triangle(
                    pts_w[f[0]], pts_w[f[1]], pts_w[f[2]], mat, li,
                    n0=None if normals is None else normals[f[0]],
                    n1=None if normals is None else normals[f[1]],
                    n2=None if normals is None else normals[f[2]],
                    uv0=(0, 0) if uvs is None else tuple(uvs[f[0]]),
                    uv1=(1, 0) if uvs is None else tuple(uvs[f[1]]),
                    uv2=(1, 1) if uvs is None else tuple(uvs[f[2]]))
                b.light_rows[li]["prim"] = ("tri", tid)
        elif name in ("cylinder", "cone", "paraboloid", "hyperboloid",
                      "heightfield", "nurbs"):
            # tessellated at build time; as in pbrt_tpu, an area light
            # does not bind to these shapes
            phimax = np.radians(p.one("phimax", 360.0))
            if name == "cylinder":
                v, fidx, nrm = tess.tessellate_cylinder(
                    p.one("radius", 1.0), p.one("zmin", -1.0),
                    p.one("zmax", 1.0), phimax)
            elif name == "cone":
                v, fidx, nrm = tess.tessellate_cone(
                    p.one("radius", 1.0), p.one("height", 1.0), phimax)
            elif name == "paraboloid":
                v, fidx, nrm = tess.tessellate_paraboloid(
                    p.one("radius", 1.0), p.one("zmin", 0.0),
                    p.one("zmax", 1.0), phimax)
            elif name == "hyperboloid":
                v, fidx, nrm = tess.tessellate_hyperboloid(
                    p.point("p1", (1, 0, 0)), p.point("p2", (1, 0, 1)),
                    phimax)
            elif name == "heightfield":
                v, fidx, nrm = tess.tessellate_heightfield(
                    p.one("nu", 2), p.one("nv", 2),
                    np.asarray(p["Pz"][1], np.float32))
            else:
                v, fidx, nrm = tess.tessellate_nurbs(
                    p.one("nu"), p.one("uorder"),
                    np.asarray(p["uknots"][1]), p.one("nv"),
                    p.one("vorder"), np.asarray(p["vknots"][1]),
                    np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                    if "P" in p else
                    np.asarray(p["Pw"][1], np.float64).reshape(-1, 4))
            b.add_mesh(self._xf_points(v), fidx, mat=mat,
                       normals=None if nrm is None
                       else self._xf_normals(nrm))
        elif name == "curve":
            # every type analytic (curve.cpp): the first four control
            # points only, as pbrt_tpu reads them (a 3n+1-point curve
            # renders its first segment)
            cp = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            w0 = p.one("width0", p.one("width", 1.0))
            w1 = p.one("width1", p.one("width", 1.0))
            sc = float(np.mean([np.linalg.norm(self.ctm[:3, k])
                                for k in range(3)]))
            n0 = n1 = None
            if str(p.one("type") or "flat").strip('"') == "ribbon" \
                    and "N" in p:
                ns = self._xf_normals(
                    np.asarray(p["N"][1], np.float64).reshape(-1, 3))
                n0 = ns[0] / max(np.linalg.norm(ns[0]), 1e-12)
                n1 = ns[-1] / max(np.linalg.norm(ns[-1]), 1e-12)
            b.add_curve(self._xf_points(cp[:4]), w0 * sc, w1 * sc, mat=mat,
                        n0=n0, n1=n1)
        elif name == "loopsubdiv":
            from pbrt_tpu_torch.frontend.loopsubdiv import loop_subdivide
            idx = np.asarray(p["indices"][1], np.int32).reshape(-1, 3)
            pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            sv, sf = loop_subdivide(pts, idx, p.one("nlevels", 3))
            b.add_mesh(self._xf_points(sv), sf, mat=mat)
        elif name == "plymesh":
            from pbrt_tpu_torch.frontend.ply import read_ply
            mesh = read_ply(os.path.join(self.base_dir, p.one("filename")))
            normals = (self._xf_normals(mesh["normals"])
                       if "normals" in mesh else None)
            b.add_mesh(self._xf_points(mesh["vertices"]), mesh["indices"],
                       mat=mat, normals=normals, uvs=mesh.get("uvs"))
        elif name == "sphere":
            # a uniform scale is assumed (world-space spheres)
            s = np.cbrt(abs(np.linalg.det(self.ctm[:3, :3])))
            sid = b.add_sphere(self._xf_point((0, 0, 0)),
                               p.one("radius", 1.0) * s, mat=mat)
            if gs.area_light is not None:
                li = self._area_light(gs)
                b.spheres[sid]["light"] = li
                b.light_rows[li]["prim"] = ("sph", sid)
        elif name == "disk":
            if gs.area_light is not None:
                _unported("area lights on disks", 8)
            c = self._xf_point((0, 0, p.one("height", 0.0)))
            n = self._xf_normals([(0, 0, 1)])[0]
            n = n / max(np.linalg.norm(n), 1e-12)
            b.add_disk(c, tuple(n), p.one("radius", 1.0),
                       p.one("innerradius", 0.0), mat=mat)
        elif name == "aaplane":
            lo_w = self._xf_point(p.point("lo", (0, 0, 0)))
            hi_w = self._xf_point(p.point("hi", (0, 0, 0)))
            pid = b.add_aaplane(
                tuple(np.minimum(lo_w, hi_w)), tuple(np.maximum(lo_w, hi_w)),
                p.one("axis", 2),
                facing_fw=p.one("facingFw", "true") in (True, "true"),
                mat=mat)
            if gs.area_light is not None:
                li = self._area_light(gs)
                b.planes[pid]["light"] = li
                b.light_rows[li]["prim"] = ("pln", pid)

    # -- the scene, camera and options ------------------------------------

    def build(self, device="cuda"):
        """(scene, camera, options) on ``device``."""
        opts = dict(self.options)
        name, cp = opts["camera"]
        c2w = np.asarray(opts["camera_to_world"], np.float64)
        c2w_end = np.asarray(opts.get("camera_to_world_end", c2w),
                             np.float64)
        # the camera's pixel spread picks the imagemaps' mip level (MIPMap
        # width from ray differentials, core/camera.cpp's 1-pixel offset)
        tex_spread = 0.0
        if name == "perspective":
            tex_spread = float(2.0 * np.tan(np.radians(
                cp.one("fov", 90.0)) / 2.0) / max(1, int(
                    opts["film"]["yres"])))
        # Accelerator "kdtree" over more than 256 triangles: the kd-tree
        # is the aggregate instead of the BVH (api.cpp:788-801), as in
        # pbrt_tpu's parser
        kd = (opts.get("accelerator") == "kdtree"
              and len(self.builder.tris) > 256)
        scene = self.builder.build(device, use_bvh="never" if kd else "auto",
                                   tex_spread=tex_spread)
        if kd:
            from pbrt_tpu_torch.scene.kdtree import build_kdtree
            scene = dataclasses.replace(scene, bvh=build_kdtree(scene))
        # pbrt's camera space is left-handed (+z forward), as look_at
        # builds it, so the matrix is used as it is
        c2w_t = tr.Transform(
            torch.as_tensor(c2w.astype(np.float32), device=scene.world_lo
                            .device),
            torch.as_tensor(np.linalg.inv(c2w).astype(np.float32),
                            device=scene.world_lo.device))
        res = (opts["film"]["xres"], opts["film"]["yres"])
        dev = scene.world_lo.device
        if name == "perspective":
            cam = cam_mod.make_perspective(
                c2w_t, cp.one("fov", 90.0), res,
                lens_radius=cp.one("lensradius", 0.0),
                focal_distance=cp.one("focaldistance", 1e6), device=dev,
                shutter_open=cp.one("shutteropen", 0.0),
                shutter_close=cp.one("shutterclose", 1.0))
        elif name == "orthographic":
            # as pbrt_tpu: the aspect's screen window, no lens, the
            # default shutter
            cam = cam_mod.make_orthographic(c2w_t, res, device=dev)
        else:
            cam = cam_mod.make_environment(c2w_t, res, device=dev)
        if not np.allclose(c2w, c2w_end):
            # an animated camera (api.cpp:814): the camera-to-world
            # interpolated per ray over [TransformTimes t0, t1]
            tt = opts.get("transform_times", (0.0, 1.0))
            cam = dataclasses.replace(cam, anim=tr.make_animated(
                c2w, c2w_end, t_start=tt[0], t_end=tt[1], device=dev))
        opts["integrator"] = _INTEGRATORS.get(opts["integrator"], "path")
        opts["max_depth"] = opts["integrator_params"].one("maxdepth", 5)
        return scene, cam, opts


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def parse_file(path: str, spectrum_cfg=spec_mod.RGB) -> PbrtParser:
    """Parse a .pbrt file into the builder's host tables (no device)."""
    with open(path) as f:
        text = f.read()
    return PbrtParser(spectrum_cfg, os.path.dirname(path) or ".").parse(text)


def parse_pbrt_string(text: str, base_dir=".", spectrum_cfg=spec_mod.RGB,
                      device="cuda"):
    """Parse scene text → (scene, camera, options) on ``device``."""
    return PbrtParser(spectrum_cfg, base_dir).parse(text).build(device)


def load_pbrt(path: str, spectrum_cfg=spec_mod.RGB, device="cuda"):
    """A .pbrt file → (scene, camera, options) on ``device``: the card
    unless the caller asks for ``device="cpu"``."""
    return parse_file(path, spectrum_cfg).build(device)
