"""Subsurface scattering against pbrt_tpu: the BSSRDF tables, the profile
sampling, the exit and entry lobes, the subsurface transport, whole
passes, and sss_oracle.pbrt / disney_sss_oracle.pbrt against the reference
binary.

(a) Tables. Each oracle file parsed by pbrt_tpu and by the port: the
    BSSRDF tables (radius grid, profiles, CDFs, rho_eff, sigma_t, r_max)
    and the material rows' sss_sigma_a / sss_sigma_s / scatter_d equal
    pbrt_tpu's bit for bit (the port's numpy table build is pbrt_tpu's),
    as do has_sss, has_disney_sss and the present types; the bridged
    scene carries the same tables.
(b) Profiles, eagerly in JAX: ``sample_sr`` and ``eval_profile_multi`` on
    seeded rows of a table of a subsurface row (g 0.3, η 1.4), a
    kdsubsurface row and a Disney row with one black channel, at seeded
    uniforms and radii: validity exact, radii and values to rtol 1e-5 /
    atol 1e-7 (XLA contracts the spline's multiply-adds).
(c) Lobes, eagerly: ``bsdf_f``, ``bsdf_pdf`` and ``bsdf_sample`` of a
    table of SSS_EXIT rows (η 1.33 and 1.5), a SUBSURFACE row, two Disney
    scatterdistance rows (the entry in the census, no DisneyDiffuse) and
    a matte row on 4,096 seeded lanes: flags exact, values rtol 1e-5 /
    atol 1e-6, but for a Disney reflection under the surface (the port's
    one deviation, held by tests/test_torch_materials.py).
(d) ``subsurface_transport`` on one batch of 4,096 hits, eagerly: rays
    from seeded points toward a kdsubsurface sphere, a Disney
    scatterdistance sphere, a subsurface box (triangles, g 0.3) and a
    matte floor, through both packages' intersect and transport. The
    batch holds specular, entering, exiting, dying and untouched lanes of
    both BSSRDF families. Entered / type / dead lanes exact; the moved
    hit, the weight and wo at rtol 1e-4 / atol 1e-5, with at most 0.5%
    of the lanes outside (a probe along a sphere's chord, where XLA's
    contracted sphere test moves t by up to 1.5e-5 relative).
(e) Passes: one `path` pass of each file and one `volpath` pass of the
    sss file's scene in a homogeneous camera medium (the transport at
    surface vertices only), each over a 16² window of the film × 4 spp
    with the file's halton sampler and depth: the file's three jitted
    pbrt_tpu programs. Per pixel rtol 1e-4 / atol 1e-5 with at most 2% of
    the pixels outside (tests/test_torch_zoo_passes.py's bound for sphere
    seams), the image mean to 1e-4 relative. The probe chain through the
    BVH: chip_smoke.py's subsurface heightfield scene
    (``entry._fill_sss_heightfield``, here at n = 8) built with a BVH
    (its cone's triangles through the traversal twin, its sphere through
    the brute-force twin) against its brute-force build, a `path` pass at
    16² × 4 spp, the same bound; its pbrt_tpu mean is held on the card.
(f) The files with tests/test_oracle.py's calls (32 spp, seed 2, `path`)
    through the port on the CPU, with its limits: sss md < 0.008 /
    bl < 0.05, disney_sss md < 0.05 / bl < 0.06.
(g) A subsurface row keeps a scene off the fused kernel.

``PYTHONPATH=. python tests/test_torch_sss.py`` prints pbrt_tpu's 8-spp
image means for chip_smoke.py's REF_SSS_MEANS.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.samplers import make_sampler as jmake_sampler
from pbrt_tpu.scene import bssrdf as jbssrdf
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import materials as jm
from pbrt_tpu.scene import media as jmedia
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.frontend import load_pbrt as tload_pbrt
from pbrt_tpu_torch.integrators import common as tcommon
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.samplers import make_sampler as tmake_sampler
from pbrt_tpu_torch.scene import bssrdf as tbssrdf
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import materials as tm
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.utils import imageio
from test_torch_oracle import _block_rel_l1, _mean_delta

jrender = importlib.import_module("pbrt_tpu.integrators.render")

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oracle")
N = 4096
RES = 96
CROP = (40, 40, 16, 16)     # a 16² window of the 96² films
SPP = 4
# file: (md limit, bl limit) of tests/test_oracle.py:163-212
FILES = {"sss": (0.008, 0.05), "disney_sss": (0.05, 0.06)}
TABLE_FIELDS = ("radius", "profile", "cdf", "rho_eff", "sigma_t", "r_max")


def _path(name):
    return os.path.join(ORACLE, f"{name}_oracle.pbrt")


def _sss_rows():
    """A subsurface row (g 0.3, η 1.4), a kdsubsurface row, a Disney row
    with a black channel, a matte row."""
    sa, ss = tbssrdf.subsurface_from_diffuse((0.5, 0.3, 0.2), 0.4, 0.0,
                                             1.33)
    return [dict(type=tm.SUBSURFACE, sss_sigma_a=(0.8, 1.2, 2.0),
                 sss_sigma_s=(9.0, 7.0, 5.0), sss_g=0.3, eta=1.4),
            dict(type=tm.SUBSURFACE, kd=(0.5, 0.3, 0.2),
                 sss_sigma_a=tuple(sa), sss_sigma_s=tuple(ss), sss_g=0.0,
                 eta=1.33),
            dict(type=tm.DISNEY, kd=(0.8, 0.4, 0.25),
                 scatter_d=(1.0, 0.6, 0.0), roughness=0.3, eta=1.5),
            dict(type=tm.MATTE, kd=(0.5, 0.5, 0.5))]


def _tables(rows):
    """pbrt_tpu's and the port's BSSRDF tables of ``rows``, each through
    its own builder (which rounds spectra to float32)."""
    jb, tb = JaxBuilder(), SceneBuilder()
    for r in rows:
        jb.add_material(**dict(r))
        tb.add_material(**dict(r))
    return (jbssrdf.build_scene_tables(jb.materials, 3),
            tbssrdf.build_scene_tables(tb.materials, 3))


# ---------------------------------------------------------------------------
# (a) tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FILES))
def test_sss_tables_match_jax(name):
    js, _, _ = jload_pbrt(_path(name))
    ts, _, _ = tload_pbrt(_path(name), device="cpu")
    bs = bridge.scene_from_jax(js)
    assert js.has_sss and ts.has_sss and bs.has_sss
    for f in TABLE_FIELDS:
        want = np.asarray(getattr(js.sss, f))
        for got in (getattr(ts.sss, f), getattr(bs.sss, f)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    for f in ("sss_sigma_a", "sss_sigma_s", "scatter_d", "mtype"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)))
    m = ts.materials
    assert m.has_disney_sss == js.materials.has_disney_sss \
        == (name == "disney_sss")
    assert m.present == tuple(js.materials.present)
    assert tm.SSS_EXIT in m.present


# ---------------------------------------------------------------------------
# (b) profiles
# ---------------------------------------------------------------------------

def _profile_inputs():
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 3 * 3, N).astype(np.int32)   # the BSSRDF rows
    u = rng.uniform(1e-6, 1 - 1e-6, N).astype(np.float32)
    radii = [np.exp(rng.uniform(np.log(1e-4), np.log(5.0), N))
             .astype(np.float32) for _ in range(3)]
    return rows, u, radii


def test_sample_sr_matches_jax():
    rows = _sss_rows()
    jt, tt = _tables(rows)
    row_id, u, _ = _profile_inputs()
    r_w, v_w = (np.asarray(x) for x in jbssrdf.sample_sr(
        jt, jnp.asarray(row_id), jnp.asarray(u)))
    r_g, v_g = tbssrdf.sample_sr(tt, torch.as_tensor(row_id),
                                 torch.as_tensor(u))
    np.testing.assert_array_equal(v_g.numpy(), v_w)
    assert 0.5 < v_w.mean() < 1.0        # the black channel is invalid
    np.testing.assert_allclose(r_g.numpy(), r_w, rtol=1e-5, atol=1e-7)


def test_eval_profile_multi_matches_jax():
    rows = _sss_rows()
    jt, tt = _tables(rows)
    row_id, _, radii = _profile_inputs()
    want, ws, wr = jbssrdf.eval_profile_multi(
        jt, jnp.asarray(row_id), [jnp.asarray(r) for r in radii])
    got, gs, gr = tbssrdf.eval_profile_multi(
        tt, torch.as_tensor(row_id), [torch.as_tensor(r) for r in radii])
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert (w > 0).mean() > 0.3
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)
    sr, s_t, _ = tbssrdf.eval_profile(tt, torch.as_tensor(row_id),
                                      torch.as_tensor(radii[0]))
    assert torch.equal(sr, got[0]) and torch.equal(s_t, gs)


# ---------------------------------------------------------------------------
# (c) the exit lobe and the Disney entry in the census
# ---------------------------------------------------------------------------

LOBE_ROWS = [dict(type=tm.SSS_EXIT, eta=1.33), dict(type=tm.SSS_EXIT),
             dict(type=tm.SUBSURFACE, sss_sigma_a=(0.8, 1.2, 2.0),
                  eta=1.4),
             dict(type=tm.DISNEY, kd=(0.8, 0.4, 0.25),
                  scatter_d=(1.0, 0.6, 0.3), roughness=0.3, eta=1.5),
             dict(type=tm.DISNEY, kd=(0.3, 0.6, 0.8), scatter_d=0.2,
                  sheen=0.5, clearcoat=0.5, roughness=0.5),
             dict(type=tm.MATTE, kd=(0.5, 0.5, 0.5))]


@pytest.mark.parametrize("func", ["f", "pdf", "sample"])
def test_exit_and_entry_lobes_match_jax(func):
    rng = np.random.default_rng(5)
    wo, wi = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(2))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    ul = rng.random(N).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    mid = (np.arange(N) % len(LOBE_ROWS)).astype(np.int32)
    jt = jm.make_material_table(LOBE_ROWS, 3)
    tt = tm.make_material_table(LOBE_ROWS, 3)
    assert tt.has_disney_sss and tt.present == tuple(jt.present)
    jp = jm.gather_materials(jt, jnp.asarray(mid))
    tp = tm.gather_materials(tt, torch.as_tensor(mid))
    J, T = jnp.asarray, torch.as_tensor
    if func == "f":
        want, got = [jm.bsdf_f(jp, J(wo), J(wi))], \
            [tm.bsdf_f(tp, T(wo), T(wi))]
    elif func == "pdf":
        want, got = [jm.bsdf_pdf(jp, J(wo), J(wi))], \
            [tm.bsdf_pdf(tp, T(wo), T(wi))]
    else:
        want = list(jm.bsdf_sample(jp, J(wo), J(ul), J(u)))
        got = list(tm.bsdf_sample(tp, T(wo), T(ul), T(u)))
        np.testing.assert_array_equal(got.pop().numpy(),
                                      np.asarray(want.pop()))
        wi = np.asarray(want[0])
    # a Disney reflection under the surface is the port's one deviation
    # (ROADMAP queue 3), held by tests/test_torch_materials.py
    disney = np.isin(mid, [3, 4])
    keep = ~(disney & (wo[:, 2] < 0) & (wi[:, 2] < 0))
    assert keep.mean() > 0.75
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy()[keep], w[keep], rtol=1e-5,
                                   atol=1e-6)
        assert (np.abs(w[keep & ~disney]) > 0).any()
        assert (np.abs(w[keep & disney]) > 0).any()


# ---------------------------------------------------------------------------
# (d) the subsurface transport on one batch of hits
# ---------------------------------------------------------------------------

def _fill_transport_scene(b):
    floor, kdsss, disney, box = (
        b.add_material(**r) for r in (
            dict(type=tm.MATTE, kd=(0.5, 0.5, 0.5)), _sss_rows()[1],
            dict(type=tm.DISNEY, kd=(0.8, 0.4, 0.25),
                 scatter_d=(1.0, 0.6, 0.3), roughness=0.3, eta=1.5),
            _sss_rows()[0]))
    b.add_mesh([(-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)],
               [(0, 1, 2), (0, 2, 3)], mat=floor)
    b.add_sphere((-1.2, 1.0, 0.0), 1.0, mat=kdsss)
    b.add_sphere((1.2, 0.8, 0.0), 0.8, mat=disney)
    lo, hi = np.array([-0.4, 0.0, 1.4]), np.array([0.4, 0.8, 2.2])
    corners = [[(hi if (i >> k) & 1 else lo)[k] for k in range(3)]
               for i in range(8)]
    faces = [(0, 2, 1), (1, 2, 3), (4, 5, 6), (5, 7, 6), (0, 1, 4),
             (1, 5, 4), (2, 6, 3), (3, 6, 7), (0, 4, 2), (2, 4, 6),
             (1, 3, 5), (3, 7, 5)]
    b.add_mesh(np.asarray(corners, np.float32), faces, mat=box)
    li = b.add_light(type="area", L=(10.0, 10.0, 10.0), prim=-1)
    sid = b.add_sphere((0.0, 4.0, -1.0), 0.4, mat=floor, light=li)
    b.light_rows[li]["prim"] = ("sph", sid)


def _transport_rays():
    rng = np.random.default_rng(9)
    o = np.stack([rng.uniform(-3, 3, N), rng.uniform(1.5, 3.5, N),
                  rng.uniform(-4, -2, N)], -1).astype(np.float32)
    target = np.stack([rng.uniform(-2.2, 2.2, N), rng.uniform(0.0, 2.0, N),
                       rng.uniform(-0.5, 2.2, N)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_subsurface_transport_matches_jax():
    jb = JaxBuilder()
    _fill_transport_scene(jb)
    js = jb.build()
    ts = bridge.scene_from_jax(js)
    assert ts.has_sss and ts.materials.has_disney_sss
    o, d = _transport_rays()
    pid = np.arange(N, dtype=np.int64) % 977
    sidx = np.arange(N, dtype=np.int64) // 977
    dims = trender._bounce_dims(1)
    beta = np.full((N, 3), 0.7, np.float32)

    jh = jisect.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          jnp.full(N, 1e30))
    jmp = jm.gather_materials(js.materials, js.mat_at(jh.prim_id))
    want = jcommon.subsurface_transport(
        js, jh, jmp, jnp.asarray(beta), jnp.asarray(-d),
        jnp.asarray(pid, jnp.uint32), jnp.asarray(sidx, jnp.uint32),
        jmake_sampler("independent"), 0, dims)
    th = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                          torch.full((N,), 1e30))
    tmp = tm.gather_materials(ts.materials, ts.mat_at(th.prim_id))
    got = tcommon.subsurface_transport(
        ts, th, tmp, torch.as_tensor(beta), torch.as_tensor(-d),
        torch.as_tensor(pid), torch.as_tensor(sidx),
        tmake_sampler("independent"), 0, dims)
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))

    hit_w, mp_w, beta_w, enter_w, wo_w = want
    hit_g, mp_g, beta_g, enter_g, wo_g = got
    enter = np.asarray(enter_w)
    mtype = np.asarray(mp_w.mtype)
    np.testing.assert_array_equal(enter_g.numpy(), enter)
    np.testing.assert_array_equal(mp_g.mtype.numpy(), mtype)
    bw = np.asarray(beta_w)
    dead = enter & (bw.max(-1) == 0)
    np.testing.assert_array_equal(
        dead, enter_g.numpy() & (beta_g.numpy().max(-1) == 0))
    # the batch covers every branch of both families
    prim_mat = np.asarray(js.mat_at(jh.prim_id))
    hit_v = np.asarray(jh.valid)
    assert (mtype == tm.MIRROR).sum() > 20                  # specular
    for m in (1, 2, 3):
        on = hit_v & (prim_mat == m)
        assert (on & enter & ~dead).sum() > 50, m           # exits
        assert (on & dead).sum() > 5, m                     # dies
    assert (hit_v & (prim_mat == 2) & ~enter).sum() > 50   # Disney surface
    off = np.zeros(N, bool)
    for name, g, w in (("p", hit_g.p, hit_w.p), ("ns", hit_g.ns, hit_w.ns),
                       ("ng", hit_g.ng, hit_w.ng), ("beta", beta_g, beta_w),
                       ("wo", wo_g, wo_w), ("kd", mp_g.kd, mp_w.kd),
                       ("kr", mp_g.kr, mp_w.kr)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        off |= ~np.isclose(g, w, rtol=1e-4, atol=1e-5).all(-1)
    assert off.mean() <= 5e-3, np.nonzero(off)[0]


# ---------------------------------------------------------------------------
# (e) passes
# ---------------------------------------------------------------------------

def _check_pass(got, want, name):
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and want.mean() > 0.01
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 0.02, f"{name}: {bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-4


@pytest.mark.parametrize("name", sorted(FILES))
def test_path_pass_matches_jax(name):
    js, jc, jo = jload_pbrt(_path(name))
    assert jo["integrator"] == "path"
    cfg = dict(integrator="path", sampler=jo["sampler"],
               max_depth=jo["max_depth"], seed=2)
    want = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"), jrender.RenderConfig(**cfg),
        RES, RES, SPP, jnp.asarray(0, jnp.uint32), crop=CROP))
    ts = bridge.scene_from_jax(js)
    assert ts.fused_profile is None and not fused_path.eligible(
        ts, trender.RenderConfig(**cfg))
    got = trender.render_pass(
        ts, bridge.camera_from_jax(jc), tfilm.make_filter("box"),
        trender.RenderConfig(**cfg), RES, RES, SPP, 0, "cpu",
        crop=CROP).numpy()
    _check_pass(got, want, name)


def test_volpath_pass_matches_jax():
    js, jc, jo = jload_pbrt(_path("sss"))
    js = dataclasses.replace(js, media=(jmedia.make_homogeneous(
        (0.05, 0.06, 0.07), (0.2, 0.2, 0.2), 0.3),), camera_med=0)
    cfg = dict(integrator="volpath", sampler=jo["sampler"],
               max_depth=jo["max_depth"], seed=2)
    want = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"), jrender.RenderConfig(**cfg),
        RES, RES, SPP, jnp.asarray(0, jnp.uint32), crop=CROP))
    ts = bridge.scene_from_jax(js)
    assert ts.has_sss and ts.camera_med == 0
    got = trender.render_pass(
        ts, bridge.camera_from_jax(jc), tfilm.make_filter("box"),
        trender.RenderConfig(**cfg), RES, RES, SPP, 0, "cpu",
        crop=CROP).numpy()
    _check_pass(got, want, "sss in fog")


def sss_heightfield(n=8, n_phi=8, n_z=4, builder=SceneBuilder):
    """``entry._fill_sss_heightfield`` in ``builder``."""
    b = builder()
    entry._fill_sss_heightfield(b, n, n_phi, n_z)
    return b


def test_bvh_probe_pass_matches_brute_force():
    b = sss_heightfield()
    bvh = b.build("cpu", use_bvh="always")
    brute = b.build("cpu", use_bvh="never")
    assert bvh.bvh is not None and brute.bvh is None and bvh.has_sss
    cam = entry._camera((64, 64), "cpu")
    crop = (24, 36, 16, 16)      # the sphere's right and the cone's left
    got, want = (trender.render_pass(
        s, cam, tfilm.make_filter("box"),
        trender.RenderConfig(sampler="halton", max_depth=5), 64, 64, SPP,
        0, "cpu", crop=crop).numpy() for s in (bvh, brute))
    _check_pass(got, want, "sss heightfield")


# ---------------------------------------------------------------------------
# (f) the files against the reference binary, (g) the fused gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FILES))
def test_sss_file_matches_reference_binary(name):
    """tests/test_oracle.py's call: `path`, 32 spp, seed 2, pbrt_tpu's
    default sampler, in one pass."""
    md_lim, bl_lim = FILES[name]
    scene, cam, opts = tload_pbrt(_path(name), device="cpu")
    img = trender.render(scene, cam, spp=32, integrator="path",
                         max_depth=opts["max_depth"], seed=2, chunk_spp=32,
                         device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, f"{name}_ref.pfm"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < md_lim, f"{name} mean delta {md:.4f}"
    assert bl < bl_lim, f"{name} block rel-L1 {bl:.4f}"


def test_subsurface_row_keeps_the_fused_kernel_out():
    for row in (_sss_rows()[1], dict(type=tm.DISNEY, scatter_d=0.2)):
        b = SceneBuilder()
        entry._fill_portal_scene(b)
        assert b.build("cpu").fused_profile is not None
        b.materials[-1] = dict(row)
        s = b.build("cpu")
        assert s.has_sss and s.fused_profile is None
        assert not fused_path.eligible(s, trender.RenderConfig())


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend with `path`, the
    halton sampler, seed 0, 8 spp: each oracle file at its resolution and
    depth, and the subsurface heightfield scene of chip_smoke.py's phase
    18 (n = 64, 64², entry._camera, max_depth 5) (REF_SSS_MEANS).
    ``PYTHONPATH=. python tests/test_torch_sss.py`` prints them."""
    out = {}
    for name in sorted(FILES):
        js, jc, jo = jload_pbrt(_path(name))
        img = jrender.render(js, jc, spp=8, integrator="path",
                             sampler="halton", max_depth=jo["max_depth"],
                             seed=0)
        out[name] = float(np.asarray(img, np.float64).mean())
    js = sss_heightfield(64, 16, 8, JaxBuilder).build(use_bvh="always")
    cam = jcam.make_perspective(jtransform.look_at(
        (0.5, 0.5, -1.4), (0.5, 0.5, 1.0), (0, 1, 0)), 40.0, (64, 64))
    img = jrender.render(js, cam, spp=8, integrator="path",
                         sampler="halton", max_depth=5, seed=0)
    out["heightfield"] = float(np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(reference_means())
