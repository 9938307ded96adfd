"""The zoo's modules against pbrt_tpu: BSDFs, the infinite, goniometric and
projection lights, the orthographic and environment cameras, the parser's
new keywords, and what still raises.

(a) BSDFs. One material table holds every ported family and both NDFs:
    Oren–Nayar matte, mirror, smooth and rough glass, plastic, metal,
    substrate, uber, translucent, dispersive glass, Disney solid with
    spectrans, thin, anisotropic metallic and clearcoat, and Beckmann
    metal, plastic and rough glass. 4,096 seeded (wo, wi, u_lobe, u) lanes
    go through ``bsdf_f``, ``bsdf_pdf`` and ``bsdf_sample`` of pbrt_tpu
    (one jitted program, the file's only one, run on two tables) and of
    the port. Flags equal
    on every lane. Values: rtol 1e-5 / atol 1e-6 (XLA's CPU code contracts
    multiply-adds, as for the BVH hits) on all but 4 lanes, and every lane
    within rtol 2e-4 / atol 2e-5 (measured: 3 lanes beyond the first, at
    most 2.0e-4 relative on a sampled direction's small component).
    Beckmann lanes: torch's erf / erfinv are not XLA's polynomials;
    measured, their sampled directions differ by at most 4.0e-6 and their
    f by 1.1e-4 relative, inside the same bound. The port's one deviation
    from pbrt_tpu: a microfacet reflection under the surface (inside a
    dielectric) takes D and the Fresnel term at the face-forwarded half
    vector, as pbrt's MicrofacetReflection does, where pbrt_tpu's D is 0
    (ROADMAP queue 3). On those lanes the port equals itself on the
    mirrored pair with the inverse index (rtol 1e-5), which pbrt_tpu
    evaluates above the surface (same bounds), but for the metallic Disney
    row; a sample under the surface carries bsdf_f and bsdf_pdf at its
    direction.
(b) Lights, eagerly in JAX (no jitted program): sample_li, pdf_li and
    escaped_radiance for an environment map, a constant infinite light,
    goniometric and projection lights with a map, point, spot and
    distant, on seeded points, samples and directions; rtol 1e-5 /
    atol 1e-6 but for the light maps' texel index at a border, where
    torch's and XLA's atan2 / acos may land in neighbouring texels (at most
    0.5% of the lanes).
(c) Cameras: orthographic (with a thin lens) and environment rays, atol
    1e-6 as the perspective camera's test.
(d) The parser: materials of every ported keyword (metal eta / k spectra,
    Beckmann, Disney parameters, dispersive glass's Cauchy fit, mixes of
    one type and of two), light maps the test writes as PFM files, and the
    cameras, table for table against pbrt_tpu's parse.
(e) What is left out raises with its ROADMAP item, and the fused kernel's
    gate refuses a portal scene with any non-matte row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import lights as jl
from pbrt_tpu.scene import materials as jm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.frontend import parser as tparser
from pbrt_tpu_torch.scene import camera as tcam
from pbrt_tpu_torch.scene import lights as tl
from pbrt_tpu_torch.scene import materials as tm
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.utils import imageio
from test_torch_frontend import _both_text
from test_torch_intersect import jax_scene
from test_torch_zoo_passes import ZOO_ROWS, env_map

N = 4096
BECKMANN_ROWS = [
    dict(type=tm.METAL, roughness=0.2, ndf=tm.NDF_BECKMANN),
    dict(type=tm.PLASTIC, kd=(0.3, 0.2, 0.1), roughness=0.3,
         ndf=tm.NDF_BECKMANN),
    dict(type=tm.GLASS, eta=1.5, roughness=0.3, ndf=tm.NDF_BECKMANN),
]
TABLE_ROWS = ZOO_ROWS + [
    dict(type=tm.DISNEY, kd=(0.3, 0.6, 0.8), clearcoat=1.0,
         clearcoat_gloss=0.7, sheen=0.5, roughness=0.5)] + BECKMANN_ROWS


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mirror(w):
    return w * np.array([1, 1, -1], np.float32)


def test_bsdfs_match_jax():
    rng = np.random.default_rng(7)
    wo, wi = _unit(rng, N), _unit(rng, N)
    ul = rng.random(N).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    mid = (np.arange(N) % len(TABLE_ROWS)).astype(np.int32)
    # the same rows with the inverse index: reflection inside a dielectric
    # is reflection outside one of index 1/eta
    inv_rows = [dict(r, eta=1.0 / r.get("eta", 1.5)) for r in TABLE_ROWS]
    jt = jm.make_material_table(TABLE_ROWS, 3)
    tt = tm.make_material_table(TABLE_ROWS, 3)
    tt_inv = tm.make_material_table(inv_rows, 3)
    assert tt.has_beckmann and tt.has_disney_trans
    assert tt.present == tuple(jt.present)

    @jax.jit
    def run(table, wo, wi, ul, u, mid):
        mp = jm.gather_materials(table, mid)
        return (jm.bsdf_f(mp, wo, wi), jm.bsdf_pdf(mp, wo, wi)) \
            + tuple(jm.bsdf_sample(mp, wo, ul, u))

    def port(table, wo, wi):
        mp = tm.gather_materials(table, torch.as_tensor(mid))
        T = torch.as_tensor
        out = [tm.bsdf_f(mp, T(wo), T(wi)), tm.bsdf_pdf(mp, T(wo), T(wi))] \
            + list(tm.bsdf_sample(mp, T(wo), T(ul), T(u)))
        return [x.numpy() for x in out], mp

    want = [np.asarray(x) for x in run(jt, wo, wi, ul, u, mid)]
    got, mp = port(tt, wo, wi)
    beck = np.isin(mid, np.arange(len(TABLE_ROWS) - len(BECKMANN_ROWS),
                                  len(TABLE_ROWS)))
    np.testing.assert_array_equal(got[5], want[5])
    np.testing.assert_allclose(got[2], want[2], rtol=2e-4, atol=2e-5)
    # a reflection under the surface: the port evaluates D and F at the
    # face-forwarded half vector, pbrt_tpu at the half vector itself
    # (ROADMAP queue 3); held apart below
    inside = (wo[:, 2] < 0) & (wi[:, 2] < 0)
    inside_s = (wo[:, 2] < 0) & (got[2][:, 2] < 0)
    outside = np.zeros(N, bool)
    for name, g, w, keep in (("f", got[0], want[0], ~inside),
                             ("pdf", got[1], want[1], ~inside),
                             ("f_s", got[3], want[3], ~inside_s),
                             ("pdf_s", got[4], want[4], ~inside_s)):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g[keep], w[keep], rtol=2e-4, atol=2e-5,
                                   err_msg=name)
        close = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        outside |= keep & ~close.reshape(N, -1).all(-1)
    close = np.isclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    outside |= ~close.all(-1)
    assert outside[~beck].sum() <= 4, np.nonzero(outside)[0]
    # under the surface: the mirrored pair with the inverse index, which
    # pbrt_tpu evaluates above the surface (but for a metallic Disney
    # row, whose Schlick term is 1 under the surface)
    metallic = np.asarray([r.get("metallic", 0.0) > 0
                           for r in TABLE_ROWS])[mid]
    mw = [np.asarray(x) for x in run(
        jm.make_material_table(inv_rows, 3), _mirror(wo), _mirror(wi), ul,
        u, mid)]
    mg, _ = port(tt_inv, _mirror(wo), _mirror(wi))
    sel = inside & ~metallic
    for k in (0, 1):
        np.testing.assert_allclose(got[k][sel], mg[k][sel], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mg[k][sel], mw[k][sel], rtol=2e-4,
                                   atol=2e-5)
    assert (got[0][sel] > 0).any(axis=-1).mean() > 0.5
    # a sample under the surface carries the BSDF and pdf at its direction
    lobe = inside_s & (got[4] > 0) & ((got[5] & tm.FLAG_SPECULAR) == 0)
    wi_s = got[2].astype(np.float32)
    at, _ = port(tt, wo, wi_s)
    np.testing.assert_allclose(got[3][lobe], at[0][lobe], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[4][lobe], at[1][lobe], rtol=1e-5,
                               atol=1e-6)
    assert lobe.sum() > 100
    # every family took part: reflection, transmission and delta lobes
    flags = got[5]
    assert {0, tm.FLAG_SPECULAR, tm.FLAG_TRANSMISSION,
            tm.FLAG_SPECULAR | tm.FLAG_TRANSMISSION} <= set(flags.tolist())
    assert (got[4][~beck] > 0).mean() > 0.6


def _light_scene(b, env):
    b.add_material(type=tm.MATTE)
    b.add_mesh([(-1, 0, -1), (2, 0, -1), (2, 0, 2)], [(0, 1, 2)])
    b.add_light(type="infinite", L=(1.2, 1.0, 0.8), env_map=env)
    b.add_light(type="goniometric", I=(3.0, 2.0, 1.0), pos=(0.5, 2.0, 0.5),
                dir=(0, -1, 0), map=env_map(6, 12))
    b.add_light(type="projection", I=(2.0, 2.0, 2.0), pos=(0.2, 1.5, -0.5),
                dir=(0.1, -1.0, 0.6), fov=35.0, map=env_map(6, 12))
    b.add_light(type="point", I=(1.0, 1.0, 1.0), pos=(0.3, 1.0, 0.2))
    b.add_light(type="spot", I=(5.0, 5.0, 5.0), pos=(0.5, 1.5, 0.5),
                dir=(0, -1, 0.2), cone_angle=25.0, cone_delta=8.0)
    b.add_light(type="distant", L=(0.5, 0.5, 0.5), dir=(0.3, -1.0, 0.2))


@pytest.mark.parametrize("env", ["map", "constant"])
def test_lights_match_jax(env):
    em = env_map() if env == "map" else np.ones((1, 1, 3), np.float32)
    js = jax_scene(_light_scene, em)
    b = SceneBuilder()
    _light_scene(b, em)
    ts = b.build("cpu")
    for k in ("ltype", "emit", "proj_fov", "env_map", "gonio_map"):
        assert torch.equal(getattr(ts.lights, k), torch.as_tensor(
            np.array(getattr(js.lights, k)))), k
    np.testing.assert_allclose(ts.lights.power.numpy(), js.lights.power,
                               rtol=1e-6)
    rng = np.random.default_rng(11)
    p = (rng.random((N, 3)) * [2.0, 1.2, 2.0] - [0.5, 0.0, 0.5]).astype(
        np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    d = _unit(rng, N)
    idx = (np.arange(N) % 6).astype(np.int32)
    J, T = jnp.asarray, torch.as_tensor
    a = jl.sample_li(js, J(idx), J(p), J(u))
    c = tl.sample_li(ts, T(idx), T(p), T(u))
    texel_ties = 0
    for k in ("wi", "li", "pdf", "p_light", "is_delta"):
        w, g = np.asarray(a[k]), c[k].numpy()
        off = ~np.isclose(g, w, rtol=1e-5, atol=1e-6).reshape(N, -1).all(-1)
        texel_ties += off.sum()
    assert texel_ties <= 0.005 * N
    np.testing.assert_allclose(
        tl.pdf_li(ts, T(idx), T(p), T(d)).numpy(),
        jl.pdf_li(js, J(idx), J(p), J(d)), rtol=1e-5, atol=1e-6)
    er_w = np.asarray(jl.escaped_radiance(js, J(d)))
    er_g = tl.escaped_radiance(ts, T(d)).numpy()
    assert (~np.isclose(er_g, er_w).all(-1)).mean() <= 0.005
    assert er_w.mean() > 0.1


def test_cameras_match_jax():
    rng = np.random.default_rng(2)
    p_film = (rng.random((N, 2)) * [96, 48]).astype(np.float32)
    u_lens = rng.random((N, 2)).astype(np.float32)
    u_time = rng.random(N).astype(np.float32)
    c2w = jtransform.look_at((0.3, 1.0, -2.0), (0.0, 0.5, 1.0), (0, 1, 0))
    for cj in (jcam.make_orthographic(c2w, (96, 48)),
               jcam.make_orthographic(c2w, (96, 48), lens_radius=0.1,
                                      focal_distance=2.0),
               jcam.make_environment(c2w, (96, 48))):
        rj = jcam.generate_rays(cj, jnp.asarray(p_film), jnp.asarray(u_lens),
                                jnp.asarray(u_time))
        rt = tcam.generate_rays(bridge.camera_from_jax(cj),
                                torch.as_tensor(p_film),
                                torch.as_tensor(u_lens),
                                torch.as_tensor(u_time))
        for k in ("o", "d"):
            np.testing.assert_allclose(getattr(rt, k).numpy(),
                                       np.asarray(getattr(rj, k)), atol=1e-6,
                                       rtol=0)


MATERIALS_TEXT = """
Camera "{camera}"
Film "image" "integer xresolution" [32] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [0.8 0.9 1.0] "string mapname" "env.pfm"
LightSource "goniometric" "rgb I" [4 4 4] "string mapname" "gonio.pfm"
AttributeBegin
Translate 0 2 0
LightSource "projection" "rgb I" [3 3 3] "float fov" [30]
  "string mapname" "gonio.pfm"
AttributeEnd
MakeNamedMaterial "gl" "string type" "glass" "float index" [1.4]
MakeNamedMaterial "mt" "string type" "matte" "rgb Kd" [0.2 0.4 0.6]
MakeNamedMaterial "p1" "string type" "plastic" "rgb Kd" [0.5 0.1 0.1]
  "float roughness" [0.2]
MakeNamedMaterial "p2" "string type" "plastic" "rgb Ks" [0.1 0.6 0.1]
Material "mix" "string namedmaterial1" "gl" "string namedmaterial2" "mt"
  "rgb amount" [0.3 0.3 0.3]
Shape "sphere" "float radius" [0.5]
Material "mix" "string namedmaterial1" "p1" "string namedmaterial2" "p2"
  "rgb amount" [0.25 0.25 0.25]
Shape "sphere" "float radius" [0.4]
Material "metal" "spectrum eta" "metal-Cu-eta.spd" "rgb k" [3.9 2.4 2.2]
Shape "sphere" "float radius" [0.3]
Material "metal" "string distribution" "beckmann"
Shape "sphere" "float radius" [0.2]
Material "mirror" "rgb Kr" [0.9 0.9 0.8]
Shape "sphere" "float radius" [0.1]
Material "substrate" "rgb Kd" [0.3 0.3 0.1] "float roughness" [0.05]
Shape "sphere" "float radius" [0.6]
Material "uber" "rgb Kd" [0.1 0.3 0.1]
Shape "sphere" "float radius" [0.7]
Material "translucent" "rgb Kt" [0.4 0.5 0.6]
Shape "sphere" "float radius" [0.8]
Material "dispersive_glass" "float etaMin" [1.49] "float etaMax" [1.63]
Shape "sphere" "float radius" [0.9]
Material "disney" "rgb color" [0.7 0.5 0.3] "float metallic" [0.2]
  "float speculartint" [0.3] "float sheen" [0.4] "float sheentint" [0.6]
  "float clearcoat" [0.5] "float clearcoatgloss" [0.8] "float eta" [1.45]
  "float anisotropic" [0.3] "float spectrans" [0.2] "float difftrans" [0.7]
  "float flatness" [0.4] "bool thin" "true"
  "rgb scatterdistance" [0.1 0.2 0.3]
Shape "sphere" "float radius" [1.0]
WorldEnd
"""


@pytest.mark.parametrize("camera", ["orthographic", "environment"])
def test_new_keywords_parse_as_pbrt_tpu(tmp_path, camera):
    imageio.write_pfm(str(tmp_path / "env.pfm"), env_map(4, 8))
    imageio.write_pfm(str(tmp_path / "gonio.pfm"), env_map(3, 6)[::-1])
    with open(tmp_path / "metal-Cu-eta.spd", "w") as f:
        f.write("400 1.2\n500 1.1\n600 0.3\n700 0.2\n")
    ts, _ = _both_text(MATERIALS_TEXT.format(camera=camera),
                       base_dir=str(tmp_path), rtol=1e-6)
    m = ts.materials
    assert ts.n_sph == 10 and ts.lights.env_map.shape == (4, 8, 3)
    assert ts.lights.gonio_map.shape == (3, 6, 3)
    # the mix of two types keeps the dominant row (matte, amount 0.3)
    # with kd scaled by 0.7; the plastic pair blends parameter-wise
    row = ts.prim_mat.long()
    assert int(m.mtype[row[0]]) == tm.MATTE
    np.testing.assert_allclose(m.kd[row[0]].numpy(),
                               0.7 * np.array([0.2, 0.4, 0.6]), rtol=1e-6)
    assert int(m.mtype[row[1]]) == tm.PLASTIC
    assert int(m.ndf[row[3]]) == tm.NDF_BECKMANN
    assert float(m.roughness[row[3]]) == pytest.approx(0.01)
    assert float(m.thin[row[9]]) == 1.0


UNPORTED = {
    "subsurface": ('Material "subsurface"', 9),
    "kdsubsurface": ('Material "kdsubsurface"', 9),
    "none": ('Material "none"', 9),
    "hair": ('Material "hair"', 8),
    "fourier": ('Material "fourier" "string bsdffile" "x.bsdf"', 8),
    "textured_kd": ('Material "matte" "texture Kd" "checks"', 8),
    "disney_scatterdistance": ('Material "disney" '
                               '"rgb scatterdistance" [0.1 0.2 0.3]', 9),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_left_out_materials_raise(name):
    text, item = UNPORTED[name]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}$"):
        tparser.parse_pbrt_string(
            f'WorldBegin\n{text}\nShape "sphere"\nWorldEnd', device="cpu")


def test_builder_rows_left_out_raise():
    for row, item in ((dict(type=tm.MATTE, kd_tex=0), 8),
                      (dict(type=tm.HAIR), 8), (dict(type=tm.FOURIER), 8),
                      (dict(type=tm.SUBSURFACE), 9), (dict(type=tm.NONE), 9),
                      (dict(type=tm.SSS_EXIT), 9),
                      (dict(type=tm.MATTE, sss_sigma_a=0.1), 9),
                      (dict(type=tm.DISNEY, scatter_d=(0.1, 0.1, 0.1)), 9)):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1 item {item}$"):
            SceneBuilder().add_material(**row)
    # a thin Disney row ignores its scatterdistance, as pbrt does
    SceneBuilder().add_material(type=tm.DISNEY, thin=1.0,
                                scatter_d=(0.1, 0.1, 0.1))


def test_fused_gate_refuses_non_matte_rows():
    """The fused kernel shades every row as matte: the portal scene takes
    it, and with any row made a mirror, or given a key beyond (type, kd,
    sigma), it does not."""
    for change in (None, dict(type=tm.MIRROR), dict(ks=(0.1, 0.1, 0.1)),
                   dict(roughness=0.1)):
        b = SceneBuilder()
        entry._fill_portal_scene(b)
        if change is not None:
            b.materials[-1] = dict(b.materials[-1], **change)
        prof = b.build("cpu").fused_profile
        assert (prof is None) == (change is not None), change
    js = jax_scene(entry._fill_portal_scene)
    assert bridge.scene_from_jax(js).fused_profile == js.fused_profile


def test_bridge_raises_on_left_out_rows():
    js = jax_scene(entry._fill_portal_scene)
    for k, v in (("mtype", tm.HAIR), ("kd_tex", 0)):
        m = dataclasses.replace(
            js.materials, **{k: jnp.asarray(np.asarray(
                getattr(js.materials, k)) * 0 + v)})
        with pytest.raises(NotImplementedError, match="item 8"):
            bridge.materials_from_jax(m)
