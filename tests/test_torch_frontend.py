"""The port's .pbrt parser against pbrt_tpu's, table for table.

Each file or scene string is parsed twice: by pbrt_tpu's ``load_pbrt`` /
``parse_pbrt_string`` (carried over with ``bridge.scene_from_jax``) and by
the port's, which needs no JAX. Geometry, material, light and bound
tables, the fused profile, the camera, the filter tables and the options
must agree exactly; parameters whose RGB pbrt_tpu computes through XLA's
float32 ``exp`` or float32 matmul (``blackbody``, ``xyz``) agree to rtol
1e-6. Families the port cannot build raise ``NotImplementedError`` naming
their ROADMAP item. No JAX program is compiled here: pbrt_tpu's parser
builds its scene eagerly.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from pbrt_tpu.frontend import parser as jparser
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.frontend import parser as tparser
from pbrt_tpu_torch.frontend.sexpr import parse_portal_data
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import lights as tlights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
FILES = {
    "cornell_portal": os.path.join(REPO, "scenes", "cornell_portal.pbrt"),
    "ao": os.path.join(ORACLE, "ao_oracle.pbrt"),
    "deltalights": os.path.join(ORACLE, "deltalights_oracle.pbrt"),
    "filter": os.path.join(ORACLE, "filter_oracle.pbrt"),
    "texinst": os.path.join(ORACLE, "texinst_oracle.pbrt"),
    "volpath": os.path.join(ORACLE, "volpath_oracle.pbrt"),
    "gridvol": os.path.join(ORACLE, "gridvol_oracle.pbrt"),
    "sss": os.path.join(ORACLE, "sss_oracle.pbrt"),
    "disney_sss": os.path.join(ORACLE, "disney_sss_oracle.pbrt"),
    "dofmotion": os.path.join(ORACLE, "dofmotion_oracle.pbrt"),
    "curves": os.path.join(ORACLE, "curves_oracle.pbrt"),
}
OPTION_KEYS = ("integrator", "max_depth", "sampler", "spp", "film",
               "filter", "accelerator")


def assert_same(a, b, path="", rtol=0.0, atol=0.0):
    """Recursive equality of two (nested) dataclasses of tensors. A BVH is
    compared by its presence only: the two packages' builders differ, and
    tests/test_torch_bvh.py holds the port's walk against pbrt_tpu's."""
    if path.endswith(".bvh"):
        assert (a is None) == (b is None), path
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if rtol or atol:
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=path)
        else:
            assert torch.equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}", rtol, atol)
    elif isinstance(a, tuple) and any(dataclasses.is_dataclass(x)
                                      for x in a):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", rtol, atol)
    else:
        assert a == b, (path, a, b)


def _both_text(text, base_dir=ORACLE, rtol=0.0):
    js, jc, jo = jparser.parse_pbrt_string(text, base_dir=base_dir)
    ts, tc, to = tparser.parse_pbrt_string(text, base_dir=base_dir,
                                           device="cpu")
    assert_same(ts, bridge.scene_from_jax(js), "scene", rtol=rtol)
    assert_same(tc, bridge.camera_from_jax(jc), "camera")
    for k in OPTION_KEYS:
        assert to.get(k) == jo.get(k), k
    return ts, to


@pytest.mark.parametrize("name", sorted(FILES))
def test_scene_files_parse_as_pbrt_tpu(name):
    """The demo scene and the oracle files the port renders here (ao,
    deltalights, filter; texinst with its texture table, mip atlas and
    instance table; volpath and gridvol with their media, the prims'
    media interface and the null material; sss and disney_sss with their
    BSSRDF tables; dofmotion with its moving box's motion and its
    camera's shutter; curves with its two cylinder curves): scene, camera,
    options and filter tables equal to pbrt_tpu's."""
    js, jc, jo = jparser.load_pbrt(FILES[name])
    ts, tc, to = tparser.load_pbrt(FILES[name], device="cpu")
    assert_same(ts, bridge.scene_from_jax(js), "scene")
    assert_same(tc, bridge.camera_from_jax(jc), "camera")
    for k in OPTION_KEYS:
        assert to.get(k) == jo.get(k), k
    fname, fkw = to["filter"]
    assert_same(tfilm.make_filter(fname, **fkw),
                bridge.filter_from_jax(jfilm.make_filter(fname, **fkw)),
                "filter")
    assert to["sampler"] == "halton"


def _ceiling_cover(scene, rows, n=64):
    """How many of the triangles ``rows`` (all in the plane y = 1) cover
    each point of an n×n grid of the unit ceiling (cell centres)."""
    g = (np.arange(n) + 0.5) / n
    px, pz = np.meshgrid(g, g)
    cover = np.zeros((n, n), np.int64)
    for r in rows:
        a, b, c = (getattr(scene.geom, k)[r].numpy()[[0, 2]].astype(
            np.float64) for k in ("tri_v0", "tri_v1", "tri_v2"))

        def side(p0, p1):
            return ((p1[0] - p0[0]) * (pz - p0[1])
                    - (p1[1] - p0[1]) * (px - p0[0]))
        s0, s1, s2 = side(a, b), side(b, c), side(c, a)
        cover += (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                  | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
    return cover


def test_demo_file_is_the_entry_scene():
    """cornell_portal.pbrt is the main path's scene: the walls, block,
    aaplane light and portal of ``entry._portal_scene``, and the camera of
    ``entry._camera((128, 128))`` (the two inverses of one LookAt are taken
    by different routes: atol 1e-6). The file cuts the ceiling around the
    opening into other slabs than ``entry`` does: its eight ceiling
    triangles (rows 8–15) differ, and cover the same region exactly once."""
    ts, tc, _ = tparser.load_pbrt(FILES["cornell_portal"], device="cpu")
    es = entry._portal_scene(device="cpu")
    assert (ts.n_tri, ts.n_sph, ts.n_pln, ts.n_dsk) == (26, 0, 1, 0)
    ceiling = list(range(8, 16))
    same = [r for r in range(26) if r not in ceiling]
    for k in ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2"):
        assert torch.equal(getattr(ts.geom, k)[same],
                           getattr(es.geom, k)[same]), k
        assert torch.equal(getattr(ts.geom, k)[ceiling][:, 1],
                           torch.full((8,), 1.0 if k[4] == "v" else -1.0)), k
    ct, ce = _ceiling_cover(ts, ceiling), _ceiling_cover(es, ceiling)
    assert np.array_equal(ct, ce)
    g = (np.arange(64) + 0.5) / 64
    inside = (g >= 0.35) & (g <= 0.65)
    assert np.array_equal(ct, 1 - (inside[:, None] & inside[None, :]))
    # the file has a material row per Material directive (and the
    # parser's default at row 0): the kernel's profile differs only in
    # the row count
    prof_t, prof_e = ts.fused_profile, es.fused_profile
    assert prof_t[:3] + prof_t[4:] == prof_e[:3] + prof_e[4:]
    assert prof_t[3] == ts.materials.kd.shape[0] == 8
    for k in ("tri_uv0", "tri_uv1", "tri_uv2", "sph_center", "sph_radius",
              "pln_lo", "pln_hi", "pln_ax", "pln_facing"):
        assert torch.equal(getattr(ts.geom, k), getattr(es.geom, k)), k
    for k in ("prim_light", "world_lo", "world_hi"):
        assert torch.equal(getattr(ts, k), getattr(es, k)), k
    kd_file = ts.materials.kd[ts.prim_mat.long()]
    kd_entry = es.materials.kd[es.prim_mat.long()]
    assert torch.equal(kd_file, kd_entry)
    assert_same(ts.lights, es.lights, "lights")
    ec = entry._camera((128, 128), device="cpu")
    assert tc.resolution == ec.resolution
    for k in ("screen_min", "screen_max", "lens_radius", "focal_distance",
              "fov_scale"):
        assert torch.equal(getattr(tc, k), getattr(ec, k)), k
    torch.testing.assert_close(tc.cam_to_world.m, ec.cam_to_world.m,
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(tc.cam_to_world.m_inv, ec.cam_to_world.m_inv,
                               atol=1e-6, rtol=0)


_CAMERA = """
Film "image" "integer xresolution" [20] "integer yresolution" [14]
Sampler "halton" "integer pixelsamples" [3]
LookAt 0.3 1.2 -3  0 0.4 0  0.1 1 0
Camera "perspective" "float fov" [38] "float lensradius" [0.02]
  "float focaldistance" [3]
"""

SCENE_STRINGS = {
    # the curve shape: its three types, widths under a scaling CTM, a
    # ribbon's normals through the inverse transpose, and a 7-point curve
    # of which pbrt_tpu reads the first four points
    "curve": """
        WorldBegin
        Shape "curve" "string type" "cylinder"
          "point P" [-0.8 0 0  -0.6 0.9 0.1  -0.2 1.1 0.2  0.0 0.2 0.3]
          "float width0" [0.12] "float width1" [0.05]
        AttributeBegin
          Translate 0.2 0.1 0
          Rotate 30 0 1 1
          Scale 1.5 0.8 1.2
          Material "matte" "rgb Kd" [0.2 0.5 0.3]
          Shape "curve" "string type" "ribbon"
            "point P" [0 0 0  0.2 0.5 0  0.4 0.6 0.2  0.5 1 0.3]
            "normal N" [0 0 1  0.3 0 1] "float width" [0.08]
          Shape "curve" "point P" [0 0 0  0.1 0.3 0  0.2 0.5 0  0.3 0.8 0
                                   0.4 0.9 0.1  0.5 1.0 0.2  0.6 1.2 0.3]
            "float width" [0.05]
        AttributeEnd
        WorldEnd""",
    # the hair material's absorption: sigma_a, color, the melanins, the
    # default; the rest of its parameters
    "hair": """
        WorldBegin
        Material "hair" "rgb sigma_a" [0.1 0.4 1.2] "float beta_m" [0.2]
          "float beta_n" [0.5] "float alpha" [3] "float eta" [1.6]
        Shape "curve" "point P" [0 0 0  0 0.3 0  0 0.6 0  0 0.9 0]
          "float width" [0.02]
        Material "hair" "rgb color" [0.6 0.3 0.1] "float beta_n" [0.4]
        Shape "curve" "point P" [0.1 0 0  0.1 0.3 0  0.1 0.6 0  0.1 0.9 0]
          "float width" [0.02]
        Material "hair" "float eumelanin" [0.3] "float pheomelanin" [0.8]
        Shape "curve" "point P" [0.2 0 0  0.2 0.3 0  0.2 0.6 0  0.2 0.9 0]
          "float width" [0.02]
        Material "hair"
        Shape "sphere" "float radius" [0.3]
        WorldEnd""",
    "transform_stack": """
        Accelerator "bvh" "string splitmethod" "middle"
        WorldBegin
        AttributeBegin
          Translate 1 2 3
          Rotate 30 0.2 1 0.1
          AttributeBegin
            Scale 2 2 2
            Shape "sphere" "float radius" [1]
          AttributeEnd
          TransformBegin
            ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0.5 -0.25 2 1]
            Shape "trianglemesh" "integer indices" [0 1 2]
              "point P" [-1 0 0  1 0 0  0 1 0]
          TransformEnd
          Shape "sphere" "float radius" [0.5]
        AttributeEnd
        Transform [0 1 0 0  -1 0 0 0  0 0 1 0  0 0 4 1]
        Shape "trianglemesh" "integer indices" [0 1 2]
          "point P" [-1 0 0  1 0 0  0 1 0]
        Identity
        Shape "sphere" "float radius" [1]
        WorldEnd""",
    "named_materials": """
        WorldBegin
        MakeNamedMaterial "red" "string type" "matte" "rgb Kd" [0.7 0.1 0.1]
        MakeNamedMaterial "rough" "string type" "matte"
          "rgb Kd" [0.2 0.3 0.4] "float sigma" [25]
        MakeNamedMaterial "blend" "string type" "mix"
          "string namedmaterial1" "red" "string namedmaterial2" "rough"
          "rgb amount" [0.3 0.3 0.3]
        AttributeBegin
          NamedMaterial "red"
          Shape "sphere" "float radius" [1]
          NamedMaterial "blend"
          Shape "sphere" "float radius" [2]
        AttributeEnd
        NamedMaterial "rough"
        Shape "trianglemesh" "integer indices" [0 1 2]
          "point P" [-1 0 0  1 0 0  0 1 0] "normal N" [0 0 1  0 0.2 1  0 1 1]
          "float uv" [0 0  1 0  0 1]
        WorldEnd""",
    "lights": """
        WorldBegin
        LightSource "point" "rgb I" [5 4 3] "point from" [0 3 0]
          "float scale" [2]
        LightSource "spot" "rgb I" [2 2 2] "point from" [0 2 0]
          "point to" [0.2 0 0] "float coneangle" [20]
          "float conedeltaangle" [4]
        AttributeBegin
          Rotate 20 1 0 0
          LightSource "distant" "rgb L" [1 1 1] "point to" [0 -1 0.2]
        AttributeEnd
        AttributeBegin
          AreaLightSource "diffuse" "rgb L" [4 4 4] "bool twosided" "true"
          Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
            "point P" [-1 2 -1  1 2 -1  1 2 1  -1 2 1]
        AttributeEnd
        AttributeBegin
          Translate 0 1 0
          AreaLightSource "area" "spectrum L" [400 1 500 3 600 6 700 9]
          Shape "sphere" "float radius" [0.25]
        AttributeEnd
        WorldEnd""",
    "quadrics_disk": """
        WorldBegin
        Translate 0.1 0.2 0.3
        Shape "cylinder" "float radius" [0.5] "float zmin" [-1]
          "float zmax" [1] "float phimax" [300]
        Shape "cone" "float radius" [0.4] "float height" [1.5]
        Shape "paraboloid" "float radius" [0.6] "float zmin" [0.1]
          "float zmax" [1]
        Shape "hyperboloid" "point p1" [1 0 0] "point p2" [0.4 0.4 1]
        Scale 2 1 1
        Shape "heightfield" "integer nu" [3] "integer nv" [2]
          "float Pz" [0 0.1 0.2  0.3 0.1 0]
        Shape "nurbs" "integer nu" [3] "integer nv" [3]
          "integer uorder" [3] "integer vorder" [3]
          "float uknots" [0 0 0 1 1 1] "float vknots" [0 0 0 1 1 1]
          "point P" [0 0 0  1 0 0.5  2 0 0  0 1 0.5  1 1 1  2 1 0.5
                     0 2 0  1 2 0.5  2 2 0]
        Rotate 40 1 0 0
        Shape "disk" "float radius" [0.8] "float innerradius" [0.2]
          "float height" [0.5]
        Shape "loopsubdiv" "integer nlevels" [2]
          "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
          "point P" [0 0 1  0.9 0 -0.3  -0.5 0.8 -0.3  -0.5 -0.8 -0.3]
        WorldEnd""",
    "spectra": """
        WorldBegin
        Material "matte" "xyz Kd" [0.3 0.35 0.2]
        Shape "sphere" "float radius" [1]
        Material "matte" "spectrum Kd" "flat.spd"
        Shape "sphere" "float radius" [1]
        AttributeBegin
          AreaLightSource "diffuse" "blackbody L" [3200 4]
          Shape "aaplane" "point lo" [-1 3 -1] "point hi" [1 3 1]
            "integer axis" [1] "bool facingFw" "false"
        AttributeEnd
        WorldEnd""",
    "instancing": """
        WorldBegin
        ObjectBegin "tet"
          Material "matte" "rgb Kd" [0.3 0.5 0.3]
          Shape "trianglemesh" "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
            "point P" [0 0.45 0  -0.35 0 0.3  0.35 0 0.3  0 0 -0.4]
            "float uv" [0.5 1  0 0  1 0  0.5 0.3]
            "normal N" [0 1 0  -1 0 1  1 0 1  0 0 -1]
        ObjectEnd
        ObjectBegin "lamp"
          Translate 0 2 0
          AreaLightSource "diffuse" "rgb L" [3 3 3]
          Shape "sphere" "float radius" [0.2]
        ObjectEnd
        AttributeBegin
          Translate -1 0 0.3
          ObjectInstance "tet"
        AttributeEnd
        AttributeBegin
          Translate 0.9 0 -0.4
          Rotate 120 0 1 0
          Scale 1.4 0.7 1.4
          ObjectInstance "tet"
          ObjectInstance "lamp"
        AttributeEnd
        ObjectInstance "missing"
        WorldEnd""",
    "textures": f"""
        WorldBegin
        Texture "img" "spectrum" "imagemap"
          "string filename" "{os.path.join(ORACLE, 'tex.png')}"
          "float uscale" [2] "float vscale" [3] "bool trilinear" "true"
        Texture "checks" "spectrum" "checkerboard" "rgb tex1" [0.9 0.1 0.1]
          "rgb tex2" [0.1 0.1 0.9] "float uscale" [8] "float vscale" [8]
        Texture "amt" "float" "fbm" "float roughness" [0.6]
          "integer octaves" [5] "float scale" [3]
        Texture "blend" "spectrum" "mix" "texture tex1" "img"
          "texture tex2" "checks" "texture amount" "amt"
        Texture "stone" "spectrum" "marble" "float variation" [0.3]
          "float scale" [2]
        Texture "gone" "spectrum" "imagemap" "string filename" "none.png"
        Material "matte" "texture Kd" "blend"
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
          "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
          "float uv" [0 0  1 0  1 1  0 1]
        Material "plastic" "texture Kd" "stone"
        Shape "sphere" "float radius" [0.5]
        Material "matte" "texture Kd" "gone"
        Shape "sphere" "float radius" [0.2]
        WorldEnd""",
    "subsurface": """
        WorldBegin
        Material "subsurface"
        Shape "sphere" "float radius" [1]
        Material "subsurface" "rgb sigma_a" [0.2 0.3 0.4]
          "rgb sigma_prime_s" [5 6 7] "float scale" [3] "float g" [0.2]
          "float eta" [1.4]
        Translate 3 0 0
        Shape "sphere" "float radius" [1]
        Material "subsurface" "rgb sigma_s" [2 3 4] "float index" [1.6]
        Translate 3 0 0
        Shape "sphere" "float radius" [1]
        Material "disney" "rgb color" [0.8 0.4 0.25]
          "rgb scatterdistance" [1.0 0.6 0.3] "float roughness" [0.3]
        Translate 3 0 0
        Shape "sphere" "float radius" [1]
        WorldEnd""",
    "kdsubsurface_float_mfp": """
        WorldBegin
        Material "kdsubsurface" "rgb Kd" [0.5 0.3 0.2] "float mfp" [0.4]
        Shape "sphere" "float radius" [1]
        Material "kdsubsurface" "rgb Kd" [0.7 0.6 0.1] "rgb mfp" [1 2 3]
          "float scale" [0.5] "float eta" [1.5] "float g" [0.1]
        Translate 3 0 0
        Shape "sphere" "float radius" [1]
        Material "kdsubsurface"
        Translate 3 0 0
        Shape "sphere" "float radius" [1]
        WorldEnd""",
    "motion": """
        ActiveTransform EndTime
        Rotate 12 0 1 0
        Translate 0.2 0 0.1
        ActiveTransform All
        TransformTimes 0.25 0.75
        Camera "perspective" "float fov" [40] "float shutteropen" [0.1]
          "float shutterclose" [0.7]
        WorldBegin
        AttributeBegin
          ActiveTransform StartTime
          Translate 0 0.5 0
          ActiveTransform EndTime
          Translate 0.3 0.5 0.1
          Rotate 20 0 0 1
          ActiveTransform All
          Scale 1 1.5 1
          Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
            "point P" [-1 0 0  1 0 0  1 1 0  -1 1 0]
          AreaLightSource "diffuse" "rgb L" [3 3 3]
          Shape "trianglemesh" "integer indices" [0 1 2]
            "point P" [-1 0 2  1 0 2  0 1 2]
        AttributeEnd
        Shape "sphere" "float radius" [0.5]
        WorldEnd""",
    "media": """
        MakeNamedMedium "air" "string type" "homogeneous"
          "rgb sigma_a" [0.01 0.02 0.03] "rgb sigma_s" [0.1 0.1 0.1]
          "float scale" [2]
        MediumInterface "air" ""
        WorldBegin
        MakeNamedMedium "cloud" "string type" "heterogeneous"
          "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.5 0.5 0.5]
          "float g" [0.3] "integer nx" [2] "integer ny" [3] "integer nz" [2]
          "point p0" [-1 0 -1] "point p1" [1 2 1]
          "float density" [0 1 2 3 4 5 6 7 8 9 10 11]
        AttributeBegin
          Material ""
          MediumInterface "cloud" "air"
          Translate 0 1 0
          Shape "sphere" "float radius" [1]
        AttributeEnd
        Material "none"
        MediumInterface "air"
        Shape "trianglemesh" "integer indices" [0 1 2]
          "point P" [-1 0 0  1 0 0  0 1 0]
        WorldEnd""",
}


def _write_ply(path, binary):
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.5]],
                     np.float32)
    norms = np.array([[0, 0, 1]] * 4, np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    head = ("ply\nformat {} 1.0\nelement vertex 4\nproperty float x\n"
            "property float y\nproperty float z\nproperty float nx\n"
            "property float ny\nproperty float nz\nproperty float u\n"
            "property float v\nelement face 1\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        if binary:
            f.write(head.format("binary_little_endian").encode())
            for v, n, t in zip(verts, norms, uvs):
                f.write(struct.pack("<8f", *v, *n, *t))
            f.write(struct.pack("<B4i", 4, 0, 1, 2, 3))
        else:
            f.write(head.format("ascii").encode())
            for v, n, t in zip(verts, norms, uvs):
                f.write((" ".join(map(str, [*v, *n, *t])) + "\n").encode())
            f.write(b"4 0 1 2 3\n")


@pytest.mark.parametrize("name", sorted(SCENE_STRINGS) + ["plymesh"])
def test_scene_strings_parse_as_pbrt_tpu(name, tmp_path):
    """Scene strings the test writes: the transform stack, named and mixed
    materials, the light types, the tessellated quadrics, a heightfield, a
    NURBS patch, a disk, a loop-subdivided mesh, PLY files (ascii and
    binary little-endian), spectrum / blackbody / xyz / .spd parameters,
    object instancing (true instances, a flattened emissive object, an
    unknown name), textures (imagemap, operands, noise, an unreadable
    image), media (a camera medium, a grid medium inside a null
    sphere, the null material) and subsurface materials (subsurface with
    its defaults, sigma_prime_s, scale and index; kdsubsurface with a
    "float mfp", which pbrt_tpu honours and warns about, an "rgb mfp" and
    its defaults; a Disney row with scatterdistance) and motion (an
    animated camera over TransformTimes with a shutter, a moving mesh
    under ActiveTransform StartTime / EndTime and an emissive mesh under
    the same CTMs), curves (cylinder, ribbon and flat under a scaling
    CTM; a 7-point curve, read to its first four points) and the hair
    material (its absorption from sigma_a, color, the melanins, the
    default)."""
    (tmp_path / "flat.spd").write_text("# a flat SPD\n400 0.6\n550 0.6\n"
                                       "700 0.6\n")
    if name == "plymesh":
        _write_ply(tmp_path / "a.ply", binary=False)
        _write_ply(tmp_path / "b.ply", binary=True)
        text = ('WorldBegin\nShape "plymesh" "string filename" "a.ply"\n'
                'Translate 0 0 1\n'
                'Shape "plymesh" "string filename" "b.ply"\nWorldEnd')
    else:
        text = SCENE_STRINGS[name]
    ts, _ = _both_text(_CAMERA + text, base_dir=str(tmp_path),
                       rtol=1e-6 if name == "spectra" else 0.0)
    if name == "quadrics_disk":
        assert ts.n_dsk == 1 and ts.n_tri > 1000
    if name == "plymesh":
        assert ts.n_tri == 4
    if name == "lights":
        assert set(ts.lights.present) == {tlights.POINT, tlights.SPOT,
                                         tlights.DISTANT, tlights.AREA}
    if name == "instancing":
        assert ts.n_vprims == 8 and ts.n_sph == 1
    if name == "textures":
        assert ts.textures.nest_depth == 1 and not ts.textures.ewa
    if name == "media":
        assert ts.camera_med == 0 and len(ts.media) == 2
    if name == "motion":
        # the moving mesh moves, the emissive one stays at the start (as
        # in pbrt_tpu), the camera is animated over TransformTimes
        assert ts.has_motion and ts.geom.tri_dv0[:2].abs().max() > 0.1
        assert float(ts.geom.tri_dv0[2:].abs().max()) == 0.0
    if name.startswith(("subsurface", "kdsubsurface")):
        assert ts.has_sss and ts.sss is not None
        assert ts.materials.has_disney_sss == (name == "subsurface")
    if name == "curve":
        assert ts.n_crv == 3 and ts.geom.crv_n is not None
    if name == "hair":
        assert ts.materials.has_hair and ts.n_crv == 3


def test_portal_data_and_float_files(tmp_path):
    """The fork's portalData s-expressions (a copy of
    tests/test_frontend.py's case) and an on-disk SPD."""
    s = ("((AA -1.2877 -1.26043 6.11473 1.2877 1.26043 6.11473 2 -) "
         "(AA -0.793266 -0.776447 8.32176 0.776447 0.776447 8.32176 "
         "2 +))")
    portals = parse_portal_data(s)
    assert len(portals) == 2
    lo, hi, ax, fw = portals[0]
    np.testing.assert_allclose(lo, (-1.2877, -1.26043, 6.11473))
    assert ax == 2 and fw is False and portals[1][3] is True
    (tmp_path / "white.spd").write_text("# comment\n400 1.0\n550 1.0\n"
                                        "700 1.0\n")
    txt = ('WorldBegin\nMaterial "matte" "spectrum Kd" "white.spd"\n'
           'Shape "sphere" "float radius" [1]\nWorldEnd')
    ps = tparser.PbrtParser(base_dir=str(tmp_path)).parse(txt)
    kd = np.asarray(ps.builder.materials[-1]["kd"])
    assert kd.shape == (3,) and (kd > 0.5).all()     # flat SPD ≈ white


def test_simple_scene_and_spd_light():
    """Copies of tests/test_frontend.py's parser basics (a simple scene,
    an SPD light, the transform stack), on the port."""
    scene, cam, opts = tparser.parse_pbrt_string("""
        Film "image" "integer xresolution" [32] "integer yresolution" [24]
        Sampler "halton" "integer pixelsamples" [7]
        Integrator "directlighting"
        LookAt 0 0 -3  0 0 0  0 1 0
        Camera "perspective" "float fov" [45]
        WorldBegin
        AttributeBegin
          Material "matte" "color Kd" [0.6 0.5 0.4]
          Shape "trianglemesh" "integer indices" [0 1 2]
            "point P" [-1 0 0  1 0 0  0 1 0]
        AttributeEnd
        LightSource "point" "rgb I" [5 5 5] "point from" [0 3 0]
        WorldEnd
    """, device="cpu")
    assert scene.n_tri == 1
    assert opts["integrator"] == "direct" and opts["spp"] == 7
    assert cam.resolution == (32, 24)
    assert int(scene.lights.ltype[0]) == tlights.POINT
    np.testing.assert_allclose(scene.lights.pos[0].numpy(), (0, 3, 0),
                               atol=1e-5)
    scene, _, _ = tparser.parse_pbrt_string("""
        WorldBegin
        AttributeBegin
          AreaLightSource "diffuse"
            "spectrum L" [400.0 0.0 500.0 8.0 600.0 15.6 700.0 18.4]
          Shape "trianglemesh" "integer indices" [0 1 2]
            "point P" [-1 0 0  1 0 0  0 1 0]
        AttributeEnd
        WorldEnd
    """, device="cpu")
    emit = scene.lights.emit[0].numpy()
    assert emit.shape == (3,) and emit[0] > emit[2]   # reddish SPD
    scene, _, _ = tparser.parse_pbrt_string("""
        WorldBegin
        AttributeBegin
          Translate 1 2 3
          AttributeBegin
            Scale 2 2 2
            Shape "sphere" "float radius" [1]
          AttributeEnd
          Shape "sphere" "float radius" [1]
        AttributeEnd
        Shape "sphere" "float radius" [1]
        WorldEnd
    """, device="cpu")
    c, r = scene.geom.sph_center.numpy(), scene.geom.sph_radius.numpy()
    np.testing.assert_allclose(c[0], (1, 2, 3), atol=1e-5)
    np.testing.assert_allclose(r[0], 2.0, atol=1e-5)
    np.testing.assert_allclose(c[1], (1, 2, 3), atol=1e-5)
    np.testing.assert_allclose(r[1], 1.0, atol=1e-5)
    np.testing.assert_allclose(c[2], (0, 0, 0), atol=1e-5)


UNPORTED = {
    "emissive_disk": ('WorldBegin\nAreaLightSource "diffuse"\n'
                      'Shape "disk"\nWorldEnd'),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_families_raise(name):
    text, item = (UNPORTED[name] if isinstance(UNPORTED[name], tuple)
                  else (UNPORTED[name], 8))
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}$"):
        tparser.parse_pbrt_string(text, device="cpu")


def test_spectral_mode_raises():
    """Spectral mode no longer raises: ao_oracle.pbrt parsed with SAMPLED
    spectra gives pbrt_tpu's 60-bin tables exactly (each RGB parameter
    lifted by ``from_rgb`` in XLA's summation order)."""
    from pbrt_tpu.core import spectrum as jspectrum
    from pbrt_tpu_torch.core import spectrum
    js, jc, jo = jparser.load_pbrt(FILES["ao"],
                                   spectrum_cfg=jspectrum.SAMPLED)
    ts, tc, to = tparser.load_pbrt(FILES["ao"], spectrum_cfg=spectrum.SAMPLED,
                                   device="cpu")
    assert ts.n_channels == 60 and ts.materials.kd.shape[-1] == 60
    assert_same(ts, bridge.scene_from_jax(js), "scene")
    assert_same(tc, bridge.camera_from_jax(jc), "camera")
    for k in OPTION_KEYS:
        assert to.get(k) == jo.get(k), k


def test_load_pbrt_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tparser.load_pbrt(FILES["ao"])


_DISKS = _CAMERA + """
WorldBegin
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
Translate 0 0.5 0
Shape "sphere" "float radius" [0.3]
Rotate 70 1 0.2 0
Shape "disk" "float radius" [0.9] "float innerradius" [0.35]
Translate 0.4 0 0.1
Shape "disk" "float radius" [0.5] "float height" [0.2]
WorldEnd"""


def _seeded_rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.6, 2.5, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_disks_intersect_as_pbrt_tpu():
    """Disks sit outside the kernels, as in pbrt_tpu: the closest hit
    (prim equal, t to rtol 2e-5 as the sphere tests) and normal, and the
    any-hit mask, of the port's brute path against pbrt_tpu's (eager, no
    jit), with two disks, one of them a ring, in front of a sphere and a
    floor; then the BVH path against the brute path on parsed quadrics
    (more than 256 triangles) and a disk: hits equal."""
    import jax.numpy as jnp
    from pbrt_tpu.scene import intersect as jisect
    from pbrt_tpu_torch.scene import intersect as tisect
    js, _, _ = jparser.parse_pbrt_string(_DISKS)
    ts, _, _ = tparser.parse_pbrt_string(_DISKS, device="cpu")
    assert ts.n_dsk == 2 and ts.bvh is None
    o, d = _seeded_rays(4096, 5)
    tmax = np.full(4096, np.inf, np.float32)
    tmax[::3] = 1.2
    jh = jisect.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tmax))
    th = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(tmax))
    prim = th.prim_id.numpy()
    assert np.array_equal(prim, np.asarray(jh.prim_id))
    hit_dsk = prim >= ts.n_tri + ts.n_sph
    assert hit_dsk.sum() > 200 and (prim == -1).sum() > 200
    ok = prim >= 0
    np.testing.assert_allclose(th.t.numpy()[ok], np.asarray(jh.t)[ok],
                               rtol=2e-5)
    np.testing.assert_allclose(th.ng.numpy()[ok], np.asarray(jh.ng)[ok],
                               atol=1e-6)
    occ_j = np.asarray(jisect.intersect_p(js, jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(tmax)))
    occ_t = tisect.intersect_p(ts, torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(tmax)).numpy()
    assert np.array_equal(occ_t, occ_j)

    ps = tparser.PbrtParser().parse(_CAMERA + """
        WorldBegin
        Shape "cylinder" "float radius" [0.5] "float zmin" [-1]
        Shape "cone" "float radius" [0.4] "float height" [1.5]
        Rotate 40 1 0 0
        Shape "disk" "float radius" [0.8] "float innerradius" [0.2]
          "float height" [0.5]
        WorldEnd""")
    with_bvh = ps.builder.build("cpu")
    brute = ps.builder.build("cpu", use_bvh="never")
    assert with_bvh.bvh is not None and with_bvh.n_dsk == 1
    o, d = _seeded_rays(4096, 6)
    o[:, 1] -= 1.0
    d = np.where(np.arange(4096)[:, None] % 2 == 0, d, -d)
    args = [torch.as_tensor(x) for x in (o, d, np.full(4096, np.inf,
                                                       np.float32))]
    hb, hr = tisect.intersect(with_bvh, *args), tisect.intersect(brute,
                                                                 *args)
    assert (hb.prim_id == with_bvh.n_prims - 1).sum() > 50   # the disk
    assert torch.equal(hb.valid, hr.valid)
    assert torch.equal(hb.prim_id[hb.prim_id >= with_bvh.n_tri],
                       hr.prim_id[hb.prim_id >= with_bvh.n_tri])
    torch.testing.assert_close(hb.t, hr.t, rtol=1e-6, atol=0)
    assert torch.equal(tisect.intersect_p(with_bvh, *args),
                       tisect.intersect_p(brute, *args))
