"""Bidirectional path tracing against pbrt_tpu: the film splat, the
camera's importance, both subpaths, every (s, t) strategy, and whole
passes of the camera strategies and of the t = 1 light-tracing splats.

Scenes (numpy-seeded geometry, built by pbrt_tpu's SceneBuilder and
carried across by ``bridge.scene_from_jax``):
- ``area``: the cornell box's aaplane light, a two-sided triangle light
  on the left wall and a sphere light, a glass sphere (delta vertices)
  and a matte one;
- ``delta_a``: tests/test_bdpt_sppm.py's floor and wall under a point, a
  spot, a distant and a goniometric light together; ``delta_b``: the same
  under a projection light and a point light (a scene holds one map);
- ``envcavity``: tests/oracle/envcavity_oracle.pbrt (the infinite light:
  its light subpaths, escapes and environment NEE);
- ``bvh``: chip_smoke.py's heightfield cornell at n = 8, built with a
  BVH (its triangles through the traversal twin).

pbrt_tpu's functions run eagerly (op by op, no jitted program: a jitted
bdpt pass takes 80 s to compile here, the eager one a few seconds once
its ops are cached), on the port's camera rays and sample keys. The
subpaths are compared field by field, the connections and MIS weights on
pbrt_tpu's own subpaths (carried into the port's Subpath), so each
strategy is held on identical inputs.

Tolerances. Integer and boolean fields exact, floats rtol 2e-5 / atol
1e-6, on all but at most 2% of the lanes. Found: subpaths 7 of 512 lanes
off on the area scene (sphere hits, whose t and normal XLA's contracted
sphere test moves by up to 3.5e-5; ROADMAP queue 3), 9 of 4,608 on
envcavity (a light vertex reached from the far disk, whose hit point
carries that distance's absolute rounding), none on the delta scenes;
strategies 1 lane of 512 (delta_a), none elsewhere. A pass's radiance per
lane at the same bound: 0 of 512 (area, bvh), 7 of 4,608 on envcavity
(a shadow ray grazing the cavity's edge flips on those last bits). The
splat pass's per-lane raster positions, contributions and masks likewise
(0 lanes off), its summed film per pixel (film.splat sums in no fixed
order on the card).
"""

import contextlib
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.integrators import bdpt as jbdpt
from pbrt_tpu.samplers import make_sampler as jmake_sampler
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.integrators import bdpt as tbdpt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import camera as tcam
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import materials as tm
from test_torch_intersect import jax_scene

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oracle")
RES, SPP = 16, 2
MAX_DEPTH = 5
FIELDS = ("vtype", "p", "ns", "ng", "beta", "pdf_fwd", "pdf_rev", "mat_id",
          "light_id", "wo", "delta", "esc", "esc_d", "esc_beta", "esc_pdf")
LANE_SHARE = 0.02


def fill_area(b):
    white = entry._cornell_box(b)
    li = b.add_light(type="area", L=(4.0, 6.0, 8.0), prim=-1, two_sided=True)
    tid = b.add_triangle((0.02, 0.3, 0.4), (0.02, 0.6, 0.5),
                         (0.02, 0.35, 0.7), mat=white, light=li)
    b.light_rows[li]["prim"] = ("tri", tid)
    li = b.add_light(type="area", L=(20.0, 12.0, 6.0), prim=-1)
    sid = b.add_sphere((0.75, 0.75, 0.6), 0.06, mat=white, light=li)
    b.light_rows[li]["prim"] = ("sph", sid)
    glass = b.add_material(type=tm.GLASS, eta=1.5)
    b.add_sphere((0.3, 0.2, 0.5), 0.2, mat=glass)
    b.add_sphere((0.7, 0.15, 0.35), 0.15, mat=white)


def fill_delta(b, kind):
    """tests/test_bdpt_sppm.py's floor and back wall under its delta
    lights; ``kind`` "a": point, spot, distant and goniometric, "b":
    projection and point."""
    m = b.add_material(type=0, kd=0.6)
    b.add_mesh([(-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_mesh([(-2, 0, 2), (2, 0, 2), (2, 3, 2), (-2, 3, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    rng = np.random.default_rng(13)
    if kind == "a":
        b.add_light(type="point", I=10.0, pos=(0, 2, 0))
        b.add_light(type="spot", I=30.0, pos=(0, 2.5, -0.5), to=(0, 0, 0),
                    cone_angle=35.0)
        b.add_light(type="distant", L=2.0, dir=(0.3, -1, 0.3))
        b.add_light(type="goniometric", I=10.0, pos=(0.5, 2, 0.3),
                    map=(0.2 + 1.3 * rng.random((8, 16, 3))
                         ).astype(np.float32))
    else:
        b.add_light(type="projection", I=40.0, pos=(0, 2.5, -0.5),
                    to=(0, 0, 0), fov=40.0,
                    map=(0.3 + rng.random((4, 4, 3))).astype(np.float32))
        b.add_light(type="point", I=5.0, pos=(1, 2, -1))


def delta_camera():
    return jcam.make_perspective(
        jtransform.look_at((0, 1.5, -3), (0, 0.5, 0), (0, 1, 0)), 45.0,
        (RES, RES))


def _jax_build(fill, *args, use_bvh="auto"):
    b = JaxBuilder(RGB)
    fill(b, *args)
    return b.build(use_bvh=use_bvh)


def _scene_case(name):
    """(pbrt_tpu scene, port scene, pbrt_tpu camera, port camera,
    max_depth)."""
    if name == "envcavity":
        js, jc, opts = jload_pbrt(os.path.join(ORACLE,
                                               "envcavity_oracle.pbrt"))
        depth = opts["max_depth"]
    elif name == "bvh":
        js = _jax_build(entry._fill_heightfield_cornell, 8, 8, 4,
                            use_bvh="always")
        jc, depth = jcam.make_perspective(
            jtransform.look_at((0.5, 0.5, -1.3), (0.5, 0.45, 0.5),
                               (0, 1, 0)), 40.0, (RES, RES)), MAX_DEPTH
    elif name == "area":
        js, depth = jax_scene(fill_area), MAX_DEPTH
        jc = jcam.make_perspective(
            jtransform.look_at((0.5, 0.5, -1.3), (0.5, 0.45, 0.5),
                               (0, 1, 0)), 40.0, (RES, RES))
    else:
        js = _jax_build(fill_delta, name[-1])
        jc, depth = delta_camera(), 4
    return (js, bridge.scene_from_jax(js), jc, bridge.camera_from_jax(jc),
            depth)


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = _scene_case(name)
    return _CASES[name]


@pytest.fixture(scope="module", autouse=True)
def _drop_cases():
    yield
    _CASES.clear()


def camera_lanes(cam_t, spp=SPP):
    """The port's camera rays and sample keys, and pbrt_tpu's copies."""
    w, h = cam_t.resolution
    rays, pid, sidx, _ = trender.camera_rays(
        cam_t, tfilm.make_filter("box"), trender.RenderConfig(), w, h, spp,
        0, "cpu")
    jl = [jnp.asarray(x.numpy()) for x in (rays.o, rays.d)] + [
        jnp.asarray(x.numpy().astype(np.uint32)) for x in (pid, sidx)]
    return (rays.o, rays.d, pid, sidx), jl


def _to_torch_subpath(sp):
    return tbdpt.Subpath(**{f: torch.as_tensor(np.array(np.asarray(
        getattr(sp, f)))) for f in FIELDS})


def _lane_mismatch(got, want, rtol=2e-5, atol=1e-6):
    """Per lane (first axis): any element off."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == bool or got.dtype.kind in "iu":
        bad = got != want
    else:
        bad = ~np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    return bad.reshape(bad.shape[0], -1).any(-1)


@pytest.fixture(scope="module")
def subpaths():
    """Both packages' camera and light subpaths of each scene."""
    out = {}
    sfn_t = trender.make_sampler("independent")
    sfn_j = jmake_sampler("independent")

    def get(name):
        if name not in out:
            js, ts, jc, tc, depth = case(name)
            v = tbdpt.max_vertices(depth)
            (o, d, pid, sidx), (jo, jd, jpid, jsidx) = camera_lanes(tc)
            out[name] = (
                (tbdpt.generate_camera_subpath(ts, o, d, v, pid, sidx, sfn_t,
                                               0, cam=tc),
                 tbdpt.generate_light_subpath(ts, v, pid, sidx, sfn_t, 0)),
                (jbdpt.generate_camera_subpath(js, jo, jd, v, jpid, jsidx,
                                               sfn_j, 0, cam=jc),
                 jbdpt.generate_light_subpath(js, v, jpid, jsidx, sfn_j, 0)))
        return out[name]
    return get


# ---------------------------------------------------------------------------
# the film splat and the camera
# ---------------------------------------------------------------------------

def test_splat_matches_pbrt_tpu():
    """Seeded raster positions (duplicates, off-film ones clipped to the
    border, masked lanes) and values: rtol 1e-6."""
    rng = np.random.default_rng(3)
    n, h, w = 4096, 12, 20
    p = rng.uniform(-2.0, 22.0, (n, 2)).astype(np.float32)
    p[: n // 4] = p[n // 4: n // 2]          # repeated pixels
    v = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    ok = rng.random(n) < 0.8
    img0 = rng.random((h, w, 3)).astype(np.float32)
    want = np.asarray(jfilm.splat(jnp.asarray(img0), jnp.asarray(p),
                                  jnp.asarray(v), jnp.asarray(ok)))
    got = tfilm.splat(torch.as_tensor(img0), torch.as_tensor(p),
                      torch.as_tensor(v), torch.as_tensor(ok)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("lens", [0.0, 0.05], ids=["pinhole", "thin_lens"])
def test_camera_we_and_pdf_dir_match_pbrt_tpu(lens):
    """Directions from the camera toward seeded points in front of it and
    behind it, a non-square film: We, the raster position, the mask and
    the directional density, rtol 1e-6."""
    c2w = jtransform.look_at((0.4, 0.6, -1.2), (0.5, 0.4, 0.5), (0, 1, 0))
    jc = jcam.make_perspective(c2w, 38.0, (24, 16), lens_radius=lens,
                               focal_distance=1.5)
    tc = bridge.camera_from_jax(jc)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 2.5, (2048, 3)).astype(np.float32)
    o = np.broadcast_to(np.asarray(c2w.apply_point(jnp.zeros((1, 3))))[0],
                        pts.shape).astype(np.float32)
    d = pts - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    we_j, pr_j, ok_j = jcam.camera_we(jc, jnp.asarray(o), jnp.asarray(d))
    we_t, pr_t, ok_t = tcam.camera_we(tc, torch.as_tensor(o),
                                      torch.as_tensor(d))
    assert 0.1 < float(np.mean(ok_j)) < 0.9
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(we_t.numpy(), np.asarray(we_j), rtol=1e-6)
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), rtol=1e-6,
                               atol=1e-5)
    pdf_j = jcam.camera_pdf_dir(jc, jnp.asarray(d))
    pdf_t = tcam.camera_pdf_dir(tc, torch.as_tensor(d))
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6)


def test_bdpt_raises_for_orthographic_and_environment_cameras():
    """pbrt_tpu's importance is the perspective camera's whatever the
    camera (ROADMAP queue 3); the port raises."""
    c2w = entry._camera((8, 8), "cpu").cam_to_world
    scene = entry._sphere_cornell("cpu")
    for cam in (tcam.make_orthographic(c2w, (8, 8)),
                tcam.make_environment(c2w, (8, 8))):
        with pytest.raises(NotImplementedError, match="perspective"):
            tcam.camera_we(cam, torch.zeros(1, 3), torch.ones(1, 3))
        with pytest.raises(NotImplementedError, match="perspective"):
            trender.render(scene, cam, spp=1, integrator="bdpt",
                           device="cpu")


# ---------------------------------------------------------------------------
# subpaths, connections and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["area", "delta_a", "delta_b",
                                  "envcavity"])
def test_subpaths_match_pbrt_tpu(subpaths, name):
    """Both subpaths of 16² × 2 spp lanes, field by field."""
    (ct, lt), (cj, lj) = subpaths(name)
    bad = np.zeros(ct.p.shape[0], bool)
    for which, t_sp, j_sp in (("camera", ct, cj), ("light", lt, lj)):
        for f in FIELDS:
            got, want = getattr(t_sp, f).numpy(), np.asarray(getattr(j_sp, f))
            assert got.shape == want.shape, (which, f)
            bad |= _lane_mismatch(got, want)
    assert bad.mean() <= LANE_SHARE, f"{name}: {bad.sum()} lanes differ"
    # the light subpaths do start on every emitter family of the scene
    assert (lt.vtype[:, 0] == tbdpt.VT_LIGHT).float().mean() > 0.4
    assert (lt.vtype[:, 1] == tbdpt.VT_SURFACE).any()


@pytest.mark.parametrize("name", ["area", "delta_a", "envcavity"])
def test_every_strategy_matches_pbrt_tpu(subpaths, name):
    """``connect_bdpt`` (contribution, mask) and ``mis_weight`` (without
    and with t' = 1) of every (s, t) strategy under the cap s + t ≤ max_v,
    and s = 0, on pbrt_tpu's own subpaths."""
    js, ts, _, _, depth = case(name)
    v = tbdpt.max_vertices(depth)
    _, (cj, lj) = subpaths(name)
    ct, lt = _to_torch_subpath(cj), _to_torch_subpath(lj)
    bad = np.zeros(ct.p.shape[0], bool)
    n_valid = 0
    for t in range(2, v + 1):
        for s in range(0, v + 1 - t):
            if s >= 1:
                cw, vw = jbdpt.connect_bdpt(js, cj, lj, s, t)
                cg, vg = tbdpt.connect_bdpt(ts, ct, lt, s, t)
                bad |= _lane_mismatch(cg.numpy(), cw, atol=1e-7)
                bad |= _lane_mismatch(vg.numpy(), vw)
                n_valid += int(np.asarray(vw).sum())
            for inc in (False, True):
                ww = jbdpt.mis_weight(js, cj, lj, s, t, include_t1=inc)
                wg = tbdpt.mis_weight(ts, ct, lt, s, t, include_t1=inc)
                bad |= _lane_mismatch(wg.numpy(), ww, atol=1e-7)
    assert n_valid > 50, f"{name}: only {n_valid} valid connections"
    assert bad.mean() <= LANE_SHARE, f"{name}: {bad.sum()} lanes differ"


# ---------------------------------------------------------------------------
# whole passes
# ---------------------------------------------------------------------------

def _li_t1_both(name, spp=SPP):
    js, ts, jc, tc, depth = case(name)
    (o, d, pid, sidx), (jo, jd, jpid, jsidx) = camera_lanes(tc, spp)
    cfg_t = trender.RenderConfig(integrator="bdpt_t1", max_depth=depth)
    jrender = importlib.import_module("pbrt_tpu.integrators.render")
    cfg_j = jrender.RenderConfig(integrator="bdpt_t1", max_depth=depth)
    got = tbdpt.li_bdpt_t1(ts, o, d, pid, sidx,
                           trender.make_sampler("independent"), cfg_t, None,
                           cam=tc).numpy()
    want = np.asarray(jbdpt.li_bdpt_t1(js, jo, jd, jpid, jsidx,
                                       jmake_sampler("independent"), cfg_j,
                                       None, cam=jc))
    return got, want


@pytest.mark.parametrize("name", ["area", "envcavity", "bvh"])
def test_li_bdpt_t1_pass_matches_pbrt_tpu(name):
    """A `bdpt_t1` pass (every camera-side strategy, t' = 1 in the
    weights) lane for lane: on the brute-force scene, on envcavity (the
    environment family) and on a BVH scene (the traversal twin)."""
    if name == "bvh":
        assert case(name)[1].bvh is not None
    got, want = _li_t1_both(name)
    assert np.isfinite(got).all() and want.mean() > 1e-3
    bad = _lane_mismatch(got, want, rtol=2e-5, atol=1e-5)
    assert bad.mean() <= LANE_SHARE, f"{name}: {bad.sum()} lanes differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


@contextlib.contextmanager
def recording_splats(module):
    """Record (p_raster, value, valid) of every ``splat`` call of
    ``module`` (pbrt_tpu's film module or the port's)."""
    calls, real = [], module.splat

    def rec(image, p_raster, value, valid):
        calls.append(tuple(np.array(np.asarray(x))
                           for x in (p_raster, value, valid)))
        return real(image, p_raster, value, valid)
    module.splat = rec
    try:
        yield calls
    finally:
        module.splat = real


@pytest.mark.parametrize("name", ["area", "delta_a"])
def test_light_splat_pass_matches_pbrt_tpu(name):
    """One `light_splat_pass` at pbrt_tpu's CPU chunk (chunk ordinal 1 of
    a 2-spp render): each strategy's per-lane raster positions,
    contributions and masks, and the summed film."""
    js, ts, jc, tc, depth = case(name)
    v = tbdpt.max_vertices(depth)
    n = RES * RES * tbdpt.default_chunk_spp("cpu", RES, RES, SPP)
    with recording_splats(jfilm) as jcalls:
        want = np.asarray(jbdpt.light_splat_pass(js, jc, n, 1, 0, v, RES,
                                                 RES))
    with recording_splats(tfilm) as tcalls:
        got = tbdpt.light_splat_pass(ts, tc, n, 1, 0, v, RES, RES).numpy()
    assert len(jcalls) == len(tcalls) == v - 1
    bad = np.zeros(n, bool)
    for (pg, cg, og), (pw, cw, ow) in zip(tcalls, jcalls):
        bad |= (og != ow) | (og & (_lane_mismatch(pg, pw, atol=1e-4)
                                   | _lane_mismatch(cg, cw, atol=1e-7)))
    assert sum(int(c[2].sum()) for c in tcalls) > 50
    assert bad.mean() <= LANE_SHARE, f"{name}: {bad.sum()} lanes differ"
    pix = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert pix.mean() <= LANE_SHARE, f"{name}: {pix.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-4


# ---------------------------------------------------------------------------
# render_bdpt and its kernel queries
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting(module, name):
    calls, real = [], getattr(module, name)

    def rec(*a, **k):
        calls.append(1)
        return real(*a, **k)
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@pytest.mark.parametrize("name", ["area", "delta_a", "envcavity", "bvh"])
def test_render_bdpt_queries_match_the_count(name):
    """A 3-spp ``render`` with `bdpt` at chunk 2 (a full chunk and pbrt_tpu's
    short last chunk): its brute-force queries (and traversals under a
    BVH) equal ``queries_per_chunk`` per chunk, and the image is the sum
    of the chunks' camera passes and splat passes over the spp."""
    _, ts, _, tc, depth = case(name)
    with counting(ik, "intersect_brute") as brute, \
            counting(bvh_ops, "bvh_traverse") as trav:
        img = tbdpt.render_bdpt(ts, tc, spp=3, max_depth=depth, seed=4,
                                chunk_spp=2, device="cpu")
    per = tbdpt.queries_per_chunk(ts, depth)
    assert len(brute) == 2 * per
    assert len(trav) == (2 * per if ts.bvh is not None else 0)
    cfg = trender.RenderConfig(integrator="bdpt_t1", max_depth=depth, seed=4)
    v = tbdpt.max_vertices(depth)
    w, h = tc.resolution
    parts = []
    for it, (off, c) in enumerate(((0, 2), (2, 1))):
        parts.append(trender.render_pass(ts, tc, tfilm.make_filter("box"),
                                         cfg, w, h, c, off, "cpu"))
        parts.append(tbdpt.light_splat_pass(ts, tc, w * h * c, it, 4, v, w,
                                            h))
    want = (parts[0] + parts[1] + parts[2] + parts[3]) / 3
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(img.numpy()).all() and float(img.mean()) > 1e-3
