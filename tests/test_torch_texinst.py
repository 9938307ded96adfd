"""Textures and object instancing: the port's scene/textures.py and
scene/instances.py against pbrt_tpu's, a `path` pass of a textured,
instanced scene lane for lane, and texinst_oracle.pbrt against the
reference binary.

- **Textures.** One table of every type (constant, scale, mix,
  checkerboard, uv, dots, bilerp, imagemap, fbm, wrinkled, windy,
  marble, and operand rows: a scale of an imagemap, a mix whose amount is
  a texture) is built by both packages from the same rows and a seeded
  13×10 image. Each type is evaluated at the same seeded uv and world
  points by both ``eval_texture``s, eagerly (no jit): without a
  footprint (level-0 bilinear), with an isotropic footprint (trilinear)
  and, on an EWA table of the rows without operands, with anisotropic
  axes. Tolerance atol 1e-6 + rtol 1e-6 (marble's spline reaches ≈ 13).
  The tables themselves, mip atlas included, are equal.
- **Instances.** A scene of two objects instanced three times under
  rotations and scales, beside plain triangles and a sphere: closest and
  any hits of seeded rays through the port's kernel-2 twin + instance
  walk (and through the BVH twin + walk, on the scene with a BVH) against
  pbrt_tpu's all-pairs brute force, prim ids exact and t at rtol 1e-5
  (with atol 1e-7: a hit 2e-3 from its origin differs by 4e-8, the last
  bits of the origin's transform into object space, which XLA sums in
  another order); the hit attributes of the instanced hits (p, normals,
  uv, dpdu, dpdv) at atol 2e-5 (the barycentrics at p carry t's last
  bits into the interpolated normal); any hits exactly.
- **A pass.** texinst_oracle.pbrt parsed by pbrt_tpu and bridged, one
  `path` render_pass at 16² × 4 spp (one jitted pbrt_tpu program),
  per pixel rtol 1e-4 / atol 1e-5 with at most 6e-3 of the pixels
  outside (seam ties, tests/test_fused_path.py:258-261), image mean
  rel 1e-4.
- **The oracle file** on the CPU with tests/test_oracle.py's call, spp,
  seed and limits (:394-410): 64 spp, seed 2, md < 0.01, bl < 0.03.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import materials as jmat
from pbrt_tpu.scene import textures as jtex
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.frontend import load_pbrt as tload_pbrt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import materials as tmat
from pbrt_tpu_torch.scene import textures as ttex
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.utils import imageio
from test_torch_intersect import box_rays, jax_scene
from test_torch_oracle import _block_rel_l1, _mean_delta

jrender = importlib.import_module("pbrt_tpu.integrators.render")

ORACLE = os.path.join(os.path.dirname(__file__), "oracle")
R = 512

# one row of every type; the scale row multiplies an imagemap operand and
# the mix row's amount is a checkerboard operand (texture rows by index)
TEX_ROWS = [
    dict(type=jtex.CONSTANT, v1=(0.2, 0.4, 0.6)),
    dict(type=jtex.SCALE, v1=(0.5, 1.0, 2.0), v2=(0.3, 0.3, 0.9)),
    dict(type=jtex.MIX, v1=(1.0, 0.0, 0.0), v2=(0.0, 0.5, 1.0), omega=0.3),
    dict(type=jtex.CHECKERBOARD, v1=(0.9, 0.8, 0.7), v2=(0.1, 0.2, 0.3),
         uscale=4.0, vscale=3.0),
    dict(type=jtex.UV, uscale=2.0, vscale=3.0, udelta=0.25, vdelta=-0.5),
    dict(type=jtex.DOTS, v1=(1.0, 1.0, 0.0), v2=(0.0, 0.2, 0.4),
         uscale=5.0, vscale=5.0),
    dict(type=jtex.BILERP, v1=(0.1, 0.9, 0.3), v2=(0.7, 0.2, 0.5)),
    dict(type=jtex.IMAGEMAP, img=0, v1=1.0, uscale=2.0, vscale=1.5),
    dict(type=jtex.FBM, v1=(1.0, 0.8, 0.6), octaves=5.0, omega=0.6,
         scale3d=2.0),
    dict(type=jtex.WRINKLED, v1=(0.5, 0.7, 0.9), octaves=4.0, omega=0.5,
         scale3d=3.0),
    dict(type=jtex.WINDY, v1=(0.9, 0.9, 0.9), omega=0.5, scale3d=1.5),
    dict(type=jtex.MARBLE, octaves=8.0, omega=0.5, scale3d=2.5,
         variation=0.4),
    dict(type=jtex.SCALE, op1=7, v2=(0.5, 0.5, 0.5)),
    dict(type=jtex.MIX, v1=(0.0, 0.0, 1.0), v2=(1.0, 1.0, 0.0), op3=3),
]
TYPE_NAMES = ["constant", "scale", "mix", "checkerboard", "uv", "dots",
              "bilerp", "imagemap", "fbm", "wrinkled", "windy", "marble",
              "scale_of_imagemap", "mix_by_texture"]
MODES = ["bilinear", "trilinear", "ewa"]


def _image():
    return np.random.RandomState(5).rand(13, 10, 3).astype(np.float32)


@pytest.fixture(scope="module")
def tex_tables():
    """(pbrt_tpu's, the port's) tables: every row with the operand rows
    (trilinear filtering), and the rows without operands with EWA
    filtering (pbrt_tpu evaluates every type once per operand level, so
    the EWA table leaves the operands out to keep its eager run short)."""
    img = [_image()]
    out = {}
    for filt, rows in (("trilinear", TEX_ROWS), ("ewa", TEX_ROWS[:12])):
        out[filt] = tuple(mod.make_texture_table(rows, img, 3, spread=0.01,
                                                 filtering=filt)
                          for mod in (jtex, ttex))
    return out


def _lookups():
    rs = np.random.RandomState(3)
    uv = rs.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    p = rs.uniform(-3.0, 3.0, (R, 3)).astype(np.float32)
    width = np.exp(rs.uniform(np.log(1e-4), np.log(0.5), R)) \
        .astype(np.float32)
    duv0 = (rs.randn(R, 2) * 0.02).astype(np.float32)
    duv1 = (rs.randn(R, 2) * 0.005).astype(np.float32)
    return uv, p, width, duv0, duv1


def test_texture_tables_equal(tex_tables):
    for filt, (jt, tt) in tex_tables.items():
        assert tt.nest_depth == jt.nest_depth == (filt == "trilinear")
        assert tt.ewa == jt.ewa == (filt == "ewa")
        for name in ("ttype", "v1", "v2", "uv_scale", "uv_delta", "img_id",
                     "octaves", "omega", "scale3d", "variation", "op1",
                     "op2", "op3", "images", "img_wh", "mip_off", "mip_wh",
                     "n_levels", "spread"):
            want = np.asarray(getattr(jt, name))
            got = getattr(tt, name).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                name


@pytest.mark.parametrize("mode", MODES)
def test_eval_texture_matches_jax(tex_tables, mode):
    """Both packages' eval_texture of every row of the mode's table at
    once (lane r reads row r mod T), held row by row."""
    jt, tt = tex_tables["ewa" if mode == "ewa" else "trilinear"]
    n_rows = int(jt.ttype.shape[0])
    uv, p, width, duv0, duv1 = _lookups()
    ids = np.arange(R, dtype=np.int32) % n_rows
    kw = {}
    if mode == "trilinear":
        kw = dict(width_uv=width)
    elif mode == "ewa":
        kw = dict(duv0=duv0, duv1=duv1)
    want = np.asarray(jtex.eval_texture(
        jt, jnp.asarray(ids), jnp.asarray(uv), jnp.asarray(p),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = ttex.eval_texture(tt, torch.as_tensor(ids), torch.as_tensor(uv),
                            torch.as_tensor(p), **{
                                k: torch.as_tensor(v)
                                for k, v in kw.items()}).numpy()
    assert got.shape == want.shape == (R, 3) and np.isfinite(got).all()
    for row in range(n_rows):
        lanes = ids == row
        np.testing.assert_allclose(got[lanes], want[lanes], atol=1e-6,
                                   rtol=1e-6, err_msg=TYPE_NAMES[row])


def test_noise_matches_jax():
    """noise3, fbm and turbulence on pbrt_tpu's hash lattice, including
    negative lattice cells."""
    p = (np.random.RandomState(9).randn(R, 3) * 7).astype(np.float32)
    oc = np.full(R, 6.0, np.float32)
    om = np.full(R, 0.55, np.float32)
    pj, pt = jnp.asarray(p), torch.as_tensor(p)
    np.testing.assert_allclose(ttex.noise3(pt).numpy(),
                               np.asarray(jtex.noise3(pj)), atol=1e-6)
    for fn in ("fbm", "turbulence"):
        got = getattr(ttex, fn)(pt, torch.as_tensor(oc), torch.as_tensor(om))
        want = getattr(jtex, fn)(pj, jnp.asarray(oc), jnp.asarray(om))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------

def _affine(scale=(1.0, 1.0, 1.0), angle_y=0.0, translate=(0, 0, 0)):
    c, s = np.cos(angle_y), np.sin(angle_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(scale)
    m[:3, 3] = translate
    return m


def fill_instance_scene(b):
    """Two objects instanced five times (rotations, uniform and
    non-uniform scales) beside a floor, a wall triangle and a sphere."""
    white = b.add_material(type=0, kd=0.7)
    green = b.add_material(type=0, kd=(0.2, 0.6, 0.3))
    b.add_mesh([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    b.add_mesh([(0, 0, 1), (1, 0, 1), (0.5, 1, 1)], [(0, 1, 2)], mat=white)
    b.add_sphere((0.8, 0.25, 0.7), 0.12, mat=green)
    tet = b.add_instanced_object()
    b.add_object_mesh(tet, [(0, 0.45, 0), (-0.35, 0, 0.3), (0.35, 0, 0.3),
                            (0, 0, -0.4)],
                      [(0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2)],
                      mat=green,
                      uvs=[(0.5, 1.0), (0.0, 0.0), (1.0, 0.0), (0.5, 0.3)])
    quad = b.add_instanced_object()
    b.add_object_mesh(quad, [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)],
                      [(0, 1, 2), (0, 2, 3)], mat=white,
                      normals=[(0.2, 0.0, 1.0), (0.0, 0.2, 1.0),
                               (-0.2, 0.0, 1.0), (0.0, -0.2, 1.0)])
    b.add_instance(tet, _affine((0.4,) * 3, 0.3, (0.3, 0.05, 0.35)))
    b.add_instance(quad, _affine((0.1, 0.2, 1.0), 0.9, (0.6, 0.4, 0.5)))
    b.add_instance(tet, _affine((0.3, 0.5, 0.3), 2.1, (0.7, 0.3, 0.3)))
    b.add_instance(quad, _affine((0.15,) * 3, -0.5, (0.3, 0.6, 0.7)))
    b.add_instance(tet, _affine((0.25,) * 3, 4.0, (0.5, 0.5, 0.2)))


@pytest.fixture(scope="module")
def inst_scenes():
    js = jax_scene(fill_instance_scene)
    b = JaxBuilder(RGB)
    fill_instance_scene(b)
    jb = b.build(use_bvh="always")
    return {"brute": (js, bridge.scene_from_jax(js)),
            "bvh": (jb, bridge.scene_from_jax(jb))}


def _inst_rays():
    o, d, _ = box_rays(17, n=4096)
    tmax = np.random.default_rng(18).uniform(0.05, 0.9, 4096).astype(
        np.float32)
    return o, d, tmax


@pytest.mark.parametrize("accel", ["brute", "bvh"])
def test_instance_closest_hits_match_jax(inst_scenes, accel):
    """The kernel twin (or the BVH twin) plus the instance walk against
    pbrt_tpu's all-pairs brute force with its instance walk."""
    js, ts = inst_scenes[accel]
    assert (ts.bvh is not None) == (accel == "bvh")
    o, d, _ = _inst_rays()
    inf = np.full(len(o), np.inf, np.float32)
    want = jisect._intersect_brute(inst_scenes["brute"][0], jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(inf))
    got = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(inf))
    prim_w = np.asarray(want.prim_id)
    prim_g = got.prim_id.numpy()
    base = ts.n_base_prims
    assert ts.n_vprims == 3 * 4 + 2 * 2 and ts.inst is not None
    assert (prim_w >= base).sum() > 200       # many rays hit an instance
    np.testing.assert_array_equal(prim_g, prim_w)
    hit = prim_w >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5, atol=1e-7)
    inst = prim_w >= base
    for name in ("p", "ng", "ns", "uv", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(got, name).numpy()[inst],
                                   np.asarray(getattr(want, name))[inst],
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("accel", ["brute", "bvh"])
def test_instance_any_hits_match_jax(inst_scenes, accel):
    js, ts = inst_scenes[accel]
    o, d, tmax = _inst_rays()
    want = np.asarray(jisect._intersect_p_brute(
        inst_scenes["brute"][0], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax)))
    got = tisect.intersect_p(ts, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(tmax)).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def test_instance_tables_equal_port_builder(inst_scenes):
    """The port's SceneBuilder builds the bridged instance table, prim
    tables and world bounds exactly."""
    b = SceneBuilder()
    fill_instance_scene(b)
    built = b.build("cpu")
    bridged = inst_scenes["brute"][1]
    for f in dataclasses.fields(built.inst):
        want, have = getattr(bridged.inst, f.name), getattr(built.inst,
                                                           f.name)
        if isinstance(want, torch.Tensor):
            assert have.dtype == want.dtype and torch.equal(have, want), \
                f.name
        else:
            assert have == want, f.name
    for name in ("prim_mat", "prim_light", "prim_med_in", "prim_med_out",
                 "world_lo", "world_hi"):
        assert torch.equal(getattr(built, name), getattr(bridged, name)), \
            name
    assert built.n_vprims == bridged.n_vprims and built.fused_profile is None


# ---------------------------------------------------------------------------
# the textured, instanced scene: resolve_kd, a pass, the oracle file
# ---------------------------------------------------------------------------

CROP = (40, 40, 16, 16)     # a 16² window of the 96² film
SPP = 4


def _texinst(filtering):
    js, jcam, opts = jload_pbrt(os.path.join(ORACLE, "texinst_oracle.pbrt"))
    assert js.textures.ewa and js.inst is not None
    if filtering == "trilinear":
        js = dataclasses.replace(js, textures=dataclasses.replace(
            js.textures, ewa=False))
    return js, jcam, opts


@pytest.mark.parametrize("filtering", ["trilinear", "ewa"])
def test_resolve_kd_matches_jax(filtering):
    """kd through the textured floor at the first hits of the file's
    camera rays (16² crop × 4 spp): the footprint (isotropic, or the
    anisotropic axes solved on the tangent plane) and the lookup, eagerly
    in pbrt_tpu. atol 1e-6."""
    js, jcam, opts = _texinst(filtering)
    ts = bridge.scene_from_jax(js)
    tcam = bridge.camera_from_jax(jcam)
    cfg = trender.RenderConfig(sampler="halton")
    rays, _, _, _ = trender.camera_rays(tcam, tfilm.make_filter("box"), cfg,
                                        96, 96, SPP, 0, "cpu", CROP)
    o, d = rays.o.numpy(), rays.d.numpy()
    inf = np.full(len(o), np.inf, np.float32)
    jhit = jisect._intersect_brute(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(inf))
    jmp = jmat.gather_materials(js.materials, js.mat_at(jhit.prim_id))
    want = np.asarray(jtex.resolve_kd(js, jmp, jhit, wo=-jnp.asarray(d)))
    thit = tisect.intersect(ts, rays.o, rays.d, torch.as_tensor(inf))
    tmp = tmat.gather_materials(ts.materials, ts.mat_at(thit.prim_id))
    got = ttex.resolve_kd(ts, tmp, thit, wo=-rays.d).numpy()
    textured = np.asarray(jmp.kd_tex) >= 0
    assert textured.mean() > 0.3
    np.testing.assert_array_equal(thit.prim_id.numpy(),
                                  np.asarray(jhit.prim_id))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_textured_instanced_pass_matches_jax():
    """texinst_oracle.pbrt parsed by pbrt_tpu (trilinear filtering: the
    jitted EWA program takes minutes to compile on the CPU), one `path`
    pass of the file's halton sampler and depth, lane for lane."""
    js, jcam, opts = _texinst("trilinear")
    want = np.asarray(jrender.render_pass(
        js, jcam, jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=opts["max_depth"], seed=2),
        96, 96, SPP, jnp.asarray(0, jnp.uint32), crop=CROP))
    ts = bridge.scene_from_jax(js)
    assert ts.fused_profile is None
    got = trender.render_pass(
        ts, bridge.camera_from_jax(jcam), tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=opts["max_depth"], seed=2),
        96, 96, SPP, 0, "cpu", crop=CROP).numpy()
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and want.mean() > 0.05
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 6e-3, f"{bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


def test_texinst_file_matches_reference_binary():
    """tests/test_oracle.py:394-410's call (64 spp, seed 2) with the file's
    halton sampler, in one pass of 64 spp."""
    scene, cam, opts = tload_pbrt(os.path.join(ORACLE,
                                               "texinst_oracle.pbrt"),
                                  device="cpu")
    assert (opts["integrator"], opts["sampler"]) == ("path", "halton")
    assert scene.textures.ewa and scene.n_vprims == 8
    img = trender.render(scene, cam, spp=64, integrator=opts["integrator"],
                         sampler=opts["sampler"],
                         max_depth=opts["max_depth"], seed=2,
                         chunk_spp=64, device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, "texinst_ref.pfm"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < 0.01, f"texinst mean delta {md:.4f}"
    assert bl < 0.03, f"texinst block rel-L1 {bl:.4f}"


def reference_means():
    """pbrt_tpu's float32 image mean on the CPU backend of
    texinst_oracle.pbrt (EWA, as the file asks) at its own resolution,
    integrator and max depth, 8 spp, the halton sampler, seed 0
    (chip_smoke.py's REF_MEDIA_MEANS). ``PYTHONPATH=. python
    tests/test_torch_texinst.py`` prints it (the EWA program takes minutes
    to compile)."""
    js, jc, jo = jload_pbrt(os.path.join(ORACLE, "texinst_oracle.pbrt"))
    img = jrender.render(js, jc, spp=8, integrator="path", sampler="halton",
                         max_depth=jo["max_depth"], seed=0)
    return {"texinst": float(np.asarray(img, np.float64).mean())}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(reference_means())
