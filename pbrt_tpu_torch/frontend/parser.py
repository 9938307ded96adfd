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

Everything pbrt_tpu's parser reads and the port cannot build yet raises
``NotImplementedError`` naming its ROADMAP queue 1 item, at the directive
that asks for it: textures, media, object instancing, curves, non-matte
materials, infinite / goniometric / projection lights, emissive disks,
motion blur, non-perspective cameras, the kd-tree and spectral mode. An
integrator keyword the port lacks raises when the scene is rendered, so
``--cat`` still reads such a file. What pbrt_tpu's parser itself skips,
or records and never reads (unknown directives, shapes, light types and
parameters, ReverseOrientation, TransformTimes), is skipped here too.
"""

from __future__ import annotations

import copy
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
from pbrt_tpu_torch.scene import tessellate as tess
from pbrt_tpu_torch.scene.materials import MATTE
from pbrt_tpu_torch.scene.types import SceneBuilder, _unported


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


_INTEGRATORS = {"path": "path", "directlighting": "direct",
                "whitted": "whitted", "ambientocclusion": "ao",
                "mypath": "mypath", "hero_path": "hero_path",
                "hero_path_mis": "hero_path_mis", "volpath": "volpath",
                "bdpt": "bdpt", "mlt": "mlt", "sppm": "sppm",
                "hero": "hero_path"}

# material keywords of pbrt_tpu's parser the port cannot build yet, with
# their ROADMAP items; any other name is matte there and here
_UNPORTED_MATERIALS = dict.fromkeys(
    ("mirror", "glass", "plastic", "metal", "dispersive_glass", "uber",
     "substrate", "translucent", "disney", "hair", "fourier"), 8)
_UNPORTED_MATERIALS.update(dict.fromkeys(
    ("subsurface", "kdsubsurface", "none", ""), 9))


class PbrtParser:
    def __init__(self, spectrum_cfg=spec_mod.RGB, base_dir="."):
        spec_mod.require_rgb(spectrum_cfg)
        self.builder = SceneBuilder()
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
        # the default material (api.cpp: matte)
        self.builder.add_material(type=MATTE, kd=0.5)

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

    def _xf_points(self, pts):
        return np.stack([self._xf_point(q) for q in pts])

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
        _unported("ObjectBegin (object instancing)", 6)

    def _d_ObjectInstance(self, tokens, peeked, nxt):
        _unported("ObjectInstance (object instancing)", 6)

    def _d_Texture(self, tokens, peeked, nxt):
        _unported("Texture (scene/textures.py)", 8)

    def _d_MakeNamedMedium(self, tokens, peeked, nxt):
        _unported("MakeNamedMedium (participating media)", 9)

    def _d_MediumInterface(self, tokens, peeked, nxt):
        """No medium can be named here (MakeNamedMedium raises), and
        pbrt_tpu reads an unknown name as vacuum: the directive changes
        nothing."""
        nxt()
        t = nxt()
        if t is not None and not t.startswith('"'):
            peeked.append(t)

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
        elif name in ("goniometric", "projection", "infinite",
                      "exinfinite"):
            _unported(f"LightSource {name!r}", 8)

    def _d_AreaLightSource(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self.gs.area_light = {"kind": name,
                              "params": self._params(tokens, peeked)}

    def _d_Shape(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self._emit_shape(name, self._params(tokens, peeked), self.gs)

    # -- construction helpers ---------------------------------------------

    def _make_material(self, name: str, p: Params) -> int:
        b = self.builder
        if name == "mix":
            # materials/mixmat.cpp, resolved at build time: two rows of one
            # type blend parameter-wise by `amount`
            m1 = self.gs.named_materials.get(p.one("namedmaterial1", ""), 0)
            m2 = self.gs.named_materials.get(p.one("namedmaterial2", ""), 0)
            amt_s = float(np.mean(p.spectrum_rgb("amount", (0.5, 0.5, 0.5))))
            r1, r2 = b.materials[m1], b.materials[m2]
            out = dict(r1)
            for key in set(r1) | set(r2):
                if key != "type":
                    out[key] = (amt_s * np.asarray(r1.get(key, 0.0),
                                                   np.float64)
                                + (1 - amt_s) * np.asarray(r2.get(key, 0.0),
                                                           np.float64))
            return b.add_material(**out)
        if name in _UNPORTED_MATERIALS:
            _unported(f"material {name!r}", _UNPORTED_MATERIALS[name])
        kw = dict(type=MATTE)
        if "Kd" in p and p["Kd"][0] == "texture":
            _unported("a textured Kd (scene/textures.py)", 8)
        if p.spectrum_rgb("Kd") is not None:
            kw["kd"] = p.spectrum_rgb("Kd")
        if p.one("sigma") is not None:
            kw["sigma"] = p.one("sigma")
        return b.add_material(**kw)

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
        b = self.builder
        mat = gs.material_id
        if name == "trianglemesh":
            idx = np.asarray(p["indices"][1], np.int32).reshape(-1, 3)
            pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            pts_w = self._xf_points(pts)
            if self.animated:
                _unported("an animated shape transform (motion blur)", 8)
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
                           uvs=uvs)
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
            _unported("Shape 'curve'", 8)
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
        if (opts.get("accelerator") == "kdtree"
                and len(self.builder.tris) > 256):
            _unported("Accelerator 'kdtree' (scene/kdtree.py)", 6)
        name, cp = opts["camera"]
        if name != "perspective":
            _unported(f"Camera {name!r}", 8)
        c2w = np.asarray(opts["camera_to_world"], np.float64)
        if not np.allclose(c2w, np.asarray(
                opts.get("camera_to_world_end", c2w), np.float64)):
            _unported("an animated camera (motion blur)", 8)
        scene = self.builder.build(device)
        # pbrt's camera space is left-handed (+z forward), as look_at
        # builds it, so the matrix is used as it is
        c2w_t = tr.Transform(
            torch.as_tensor(c2w.astype(np.float32), device=scene.world_lo
                            .device),
            torch.as_tensor(np.linalg.inv(c2w).astype(np.float32),
                            device=scene.world_lo.device))
        cam = cam_mod.make_perspective(
            c2w_t, cp.one("fov", 90.0),
            (opts["film"]["xres"], opts["film"]["yres"]),
            lens_radius=cp.one("lensradius", 0.0),
            focal_distance=cp.one("focaldistance", 1e6),
            device=scene.world_lo.device)
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
