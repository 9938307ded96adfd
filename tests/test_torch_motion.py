"""Two-keyframe motion blur against pbrt_tpu: the AnimatedTransform, the
parser's two CTMs, the animated camera, both kernels' motion variants
(their plain-torch twins here) and whole passes of dofmotion_oracle.pbrt.

Scenes are built by pbrt_tpu (its SceneBuilder or its parser) and carried
across with ``bridge.scene_from_jax``, or parsed by both packages from one
file. pbrt_tpu runs eagerly (op by op, its jitted pass unwrapped and its
loops run in Python): its motion path is plain jnp on the CPU (no Pallas
kernel takes a time), and a jitted pass would compile for tens of
seconds and contract multiply-adds across ops.

Tolerances. The AnimatedTransform's matrices rtol 1e-6 (atol 1e-7 where
an entry is near 0); the camera's rays atol 1e-6 (the static camera's
rule, tests/test_torch_camera_film.py). Hits: prim ids equal, t rtol 1e-5
(XLA contracts the lerp v + time·dv and the triangle test into
multiply-adds, the twins round every operation; found: t within 1.3e-6
relative). A pass's radiance per lane rtol 2e-5 / atol 1e-6 on all but
at most 2% of the lanes (found: 0 of 9,216 lanes off in each pass). The motion
variants of the kernels run no warp-wide early reject (each lane's row is
its own), so there is no reject proof to extend; at shutter time 0 the
motion twin equals the static twin bit for bit.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.frontend import parser as jparser
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.core import transform as ttransform
from pbrt_tpu_torch.frontend import parser as tparser
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import bvh as tbvh
from pbrt_tpu_torch.scene import camera as tcam
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.utils import imageio

# each xdist worker's share of the cores
import test_torch_intersect  # noqa: F401

jrender = importlib.import_module("pbrt_tpu.integrators.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
DOFMOTION = os.path.join(ORACLE, "dofmotion_oracle.pbrt")
LANES_OFF = 0.02


def _rot(axis, deg):
    return ttransform.rotate_matrix(deg, axis).astype(np.float64)


def _keyframe(rng):
    """A random 4×4: translation · rotation · scale with shear."""
    m = _rot(rng.normal(size=3), rng.uniform(-170, 170))
    s = np.eye(4)
    s[:3, :3] = np.diag(rng.uniform(0.5, 2.0, 3))
    s[0, 1] = rng.uniform(-0.3, 0.3)
    m = m @ s
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m


def _jtr(m):
    return jtransform.Transform(jnp.asarray(m, jnp.float32),
                                jnp.asarray(np.linalg.inv(m), jnp.float32))


@pytest.mark.parametrize("case", ["rotating", "near"])
def test_animated_transform_matches_pbrt_tpu(case):
    """decompose, slerp (its far branch, and its lerp branch where the two
    rotations nearly agree) and interpolate, at times inside and outside
    [start, end]."""
    rng = np.random.default_rng(3)
    m0 = _keyframe(rng)
    m1 = _keyframe(rng) if case == "rotating" else m0 @ _rot((0, 1, 0), 0.5)
    times = np.concatenate([rng.uniform(0.2, 0.9, 64), [0.0, 0.2, 0.9, 1.5],
                            [-0.3]]).astype(np.float32)
    ta = ttransform.make_animated(m0, m1, 0.2, 0.9)
    ja = jtransform.make_animated(_jtr(m0), _jtr(m1), t_start=0.2, t_end=0.9)
    for f in dataclasses.fields(ta):
        np.testing.assert_allclose(getattr(ta, f.name).numpy(),
                                   np.asarray(getattr(ja, f.name)),
                                   rtol=1e-6, atol=1e-7, err_msg=f.name)
    got = ta.interpolate(torch.as_tensor(times)).numpy()
    want = np.asarray(ja.interpolate(jnp.asarray(times)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_dofmotion_tables_match_pbrt_tpu():
    """dofmotion_oracle.pbrt: the builder rows each parser writes (the
    vertices through the start CTM, the moving box's through the end
    CTM), the scene's motion tables and world bounds, the camera with its
    shutter."""
    jp = jparser.PbrtParser(RGB, ORACLE)
    tp = tparser.PbrtParser(base_dir=ORACLE)
    text = open(DOFMOTION).read()
    jp.parse(text)
    tp.parse(text)
    assert len(jp.builder.tris) == len(tp.builder.tris) == 26
    moving = 0
    for jr, tr in zip(jp.builder.tris, tp.builder.tris):
        for k in ("v0", "v1", "v2", "v0_e", "v1_e", "v2_e"):
            if jr[k] is None:
                assert tr[k] is None, k
            else:
                assert np.array_equal(np.asarray(jr[k], np.float32),
                                      np.asarray(tr[k], np.float32)), k
        moving += jr["v0_e"] is not None
    assert moving == 12
    js, jc, _ = jload_pbrt(DOFMOTION)
    ts, tc, _ = tparser.load_pbrt(DOFMOTION, device="cpu")
    bs = bridge.scene_from_jax(js)
    assert ts.has_motion and bs.has_motion and ts.bvh is None
    for k in ("tri_v0", "tri_v1", "tri_v2", "tri_dv0", "tri_dv1", "tri_dv2"):
        assert torch.equal(getattr(ts.geom, k), getattr(bs.geom, k)), k
    assert torch.equal(ts.world_lo, bs.world_lo)
    assert torch.equal(ts.world_hi, bs.world_hi)
    assert float(ts.geom.tri_dv0.abs().max()) == pytest.approx(0.6)
    bc = bridge.camera_from_jax(jc)
    for k in ("shutter_open", "shutter_close", "lens_radius",
              "focal_distance"):
        assert torch.equal(getattr(tc, k), getattr(bc, k)), k
    assert tc.anim is None and bc.anim is None
    assert ts.fused_profile is None


CAMERA_TEXT = """
Film "image" "integer xresolution" [24] "integer yresolution" [16]
LookAt 0.3 1.2 -3  0 0.4 0  0.1 1 0
ActiveTransform EndTime
Rotate 14 0 1 0.2
Translate 0.4 -0.1 0.3
ActiveTransform All
TransformTimes 0.1 0.8
Camera "perspective" "float fov" [38] "float lensradius" [0.05]
  "float focaldistance" [3] "float shutteropen" [0.05]
  "float shutterclose" [0.9]
WorldBegin
Shape "sphere" "float radius" [1]
WorldEnd
"""


def test_animated_camera_rays_match_pbrt_tpu():
    """An animated camera (differing CTMs at Camera, TransformTimes, a
    shutter and a lens): the parsed AnimatedTransform equal to pbrt_tpu's
    and the rays at random shutter samples within atol 1e-6."""
    _, jc, _ = jparser.parse_pbrt_string(CAMERA_TEXT)
    _, tc, _ = tparser.parse_pbrt_string(CAMERA_TEXT, device="cpu")
    assert tc.anim is not None and jc.anim is not None
    bc = bridge.camera_from_jax(jc)
    for f in dataclasses.fields(ttransform.AnimatedTransform):
        assert torch.equal(getattr(tc.anim, f.name),
                           getattr(bc.anim, f.name)), f.name
    assert float(tc.shutter_open) == pytest.approx(0.05)
    rng = np.random.default_rng(5)
    n = 512
    p_film = (rng.uniform(0, 1, (n, 2)) * [24, 16]).astype(np.float32)
    u_lens = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u_time = rng.uniform(0, 1, n).astype(np.float32)
    rj = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(u_lens),
                            jnp.asarray(u_time))
    rt = tcam.generate_rays(tc, torch.as_tensor(p_film),
                            torch.as_tensor(u_lens), torch.as_tensor(u_time))
    np.testing.assert_allclose(rt.o.numpy(), np.asarray(rj.o), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(rt.d.numpy(), np.asarray(rj.d), atol=1e-6,
                               rtol=0)
    # the rays move with the shutter sample
    r0 = tcam.generate_rays(tc, torch.as_tensor(p_film),
                            torch.as_tensor(u_lens), torch.zeros(n))
    assert float((r0.o - rt.o).abs().max()) > 1e-2


def _fill_moving(b, n_tri, seed=0):
    """Random triangles, two of three moving (translated and sheared),
    a sphere, an aaplane and a point light."""
    rng = np.random.default_rng(seed)
    m = b.add_material(type=0, kd=0.5)
    for i in range(n_tri):
        v = rng.uniform(-1, 1, 3) + rng.uniform(-0.3, 0.3, (3, 3))
        dv = rng.uniform(-0.2, 0.2, 3) if i % 3 else np.zeros(3)
        b.add_triangle(*v, mat=m, v0_e=v[0] + dv, v1_e=v[1] + 1.5 * dv,
                       v2_e=v[2] - dv)
    b.add_sphere((0.2, 0.1, 2.5), 0.5, mat=m)
    b.add_aaplane((-3, -3, 3.2), (3, 3, 3.2), 2, mat=m)
    b.add_light(type="point", I=1.0, pos=(0, 5, 0))


@pytest.fixture(scope="module")
def moving_pair():
    """The moving scene (300 triangles) without and with a BVH, built by
    pbrt_tpu and carried across, and seeded rays with shutter times."""
    out = {}
    for use_bvh in ("never", "always"):
        b = JaxBuilder(RGB)
        _fill_moving(b, 300)
        js = b.build(use_bvh=use_bvh)
        out[use_bvh] = (js, bridge.scene_from_jax(js))
    rng = np.random.default_rng(11)
    R = 4096
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    o[:, 2] = -4
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0, 1, R).astype(np.float32)
    return out, (o, d, tm)


@pytest.mark.parametrize("accel, query", [
    ("never", "closest"), ("never", "any"), ("always", "closest"),
    ("always", "any")])
def test_motion_queries_match_pbrt_tpu(moving_pair, accel, query):
    """Closest and any-hit queries at the rays' shutter times through the
    motion twin of kernel 2 (no BVH) and of kernel 3 with kernel 2 (a BVH
    over both keyframes), against pbrt_tpu's ``_intersect_brute`` /
    ``_traverse_batch`` with ``time``: prim ids and occlusion equal, t rtol
    1e-5, the hit's point and normals from the moved vertices."""
    scenes, (o, d, tm) = moving_pair
    js, ts = scenes[accel]
    assert (ts.bvh is not None) == (accel == "always")
    if accel == "always":
        assert ts.bvh.tris_motion is not None
    R = o.shape[0]
    targs = (torch.as_tensor(o), torch.as_tensor(d))
    jargs = (jnp.asarray(o), jnp.asarray(d))
    if query == "any":
        occ_j = np.asarray(jisect.intersect_p(js, *jargs, jnp.full(R, 4.5),
                                              time=jnp.asarray(tm)))
        occ_t = tisect.intersect_p(ts, *targs, torch.full((R,), 4.5),
                                   time=torch.as_tensor(tm)).numpy()
        assert np.array_equal(occ_j, occ_t) and 0.05 < occ_t.mean() < 0.95
        return
    hj = jisect.intersect(js, *jargs, jnp.full(R, 1e30),
                          time=jnp.asarray(tm))
    ht = tisect.intersect(ts, *targs, torch.full((R,), 1e30),
                          time=torch.as_tensor(tm))
    prim = ht.prim_id.numpy()
    assert np.array_equal(np.asarray(hj.prim_id), prim)
    hit = prim >= 0
    assert hit.mean() > 0.1 and (prim[hit] < ts.n_tri).sum() > 300
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-5)
    for k in ("p", "ns", "ng"):
        np.testing.assert_allclose(getattr(ht, k).numpy()[hit],
                                   np.asarray(getattr(hj, k))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # without times the same queries see the triangles at time 0
    h0 = tisect.intersect(ts, *targs, torch.full((R,), 1e30))
    hj0 = jisect.intersect(js, *jargs, jnp.full(R, 1e30))
    assert np.array_equal(np.asarray(hj0.prim_id), h0.prim_id.numpy())
    assert not np.array_equal(h0.prim_id.numpy(), prim)


def test_motion_twins_at_time_zero_equal_the_static_twins(moving_pair):
    """At shutter time 0 the motion twin of kernel 2 gives the static
    twin's t and prim bit for bit (v + 0·dv = v, the same edges), and the
    motion twin of kernel 3 the static one's."""
    scenes, (o, d, _) = moving_pair
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    R = o.shape[0]
    zero, inf = torch.zeros(R), torch.full((R,), 1e30)
    ts = scenes["never"][1]
    t_s, p_s = ik._intersect_reference(*ik.pack_scene(ts), o, d, inf,
                                       ts.n_tri, ts.n_sph, ts.n_pln)
    t_m, p_m = ik.intersect_brute_motion(*ik.pack_scene(ts, motion=True), o,
                                         d, inf, zero, ts.n_tri, ts.n_sph,
                                         ts.n_pln)
    assert torch.equal(t_s, t_m) and torch.equal(p_s, p_m)
    bvh = scenes["always"][1].bvh
    for any_hit in (False, True):
        a = bvh_ops.traverse_reference(bvh, o, d, inf, any_hit)
        b = bvh_ops.bvh_traverse_motion(bvh, o, d, inf, zero, any_hit)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_motion_bvh_build_matches_pbrt_tpu(moving_pair):
    """The port's own build of the moving scene: pbrt_tpu's tree node for
    node (binned SAH over the union of both keyframes' bounds, no spatial
    splits: each triangle in one leaf), and the motion records as the
    bridge carries pbrt_tpu's 18-column rows across."""
    js, ts = moving_pair[0]["always"]
    own = tbvh.build_bvh(ts)
    assert own.built_by == "native-sah"
    for k in ("lo", "hi", "right", "count", "axis"):
        assert np.array_equal(getattr(own, k).numpy(),
                              np.asarray(getattr(js.bvh, k))), k
    assert np.array_equal(own.prim_order.numpy(),
                          np.asarray(js.bvh.prim_order))
    assert sorted(own.prim_order.tolist()) == list(range(ts.n_tri))
    assert torch.equal(own.tris_motion, ts.bvh.tris_motion)
    assert torch.equal(own.tris, ts.bvh.tris)
    rec = own.tris_motion.numpy()
    i = int(own.prim_order[5])
    assert np.array_equal(rec[5, 9:12], ts.geom.tri_dv0[i].numpy())
    assert np.array_equal(rec[5, 3:6], ts.geom.tri_v1[i].numpy())


def test_static_scene_tables_unchanged():
    """A scene without motion keeps every static table: no motion fields,
    9-column kernel rows v0, e1, e2, 48-byte BVH records and no motion
    records, its fused profile; the same scene with one moving triangle
    loses the fused gate (as pbrt_tpu's), and its kernel rows become
    v0, v1, v2, dv0, dv1, dv2."""
    scene = entry._portal_scene("cpu")
    assert not scene.has_motion and scene.geom.tri_dv0 is None
    assert scene.fused_profile is not None
    tri = ik.pack_scene(scene)[0]
    g = scene.geom
    assert tri.shape == (scene.n_tri, 9)
    assert torch.equal(tri, torch.cat([g.tri_v0, g.tri_v1 - g.tri_v0,
                                       g.tri_v2 - g.tri_v0], -1))
    cfg = trender.RenderConfig()
    assert fused_path.eligible(scene, cfg)
    hf = entry._heightfield_cornell("cpu", 16)
    assert hf.bvh.tris_motion is None and hf.bvh.tris.shape[1] == 12
    assert hf.bvh.built_by == "native-sbvh"
    moved = []
    for builder in (JaxBuilder(RGB), SceneBuilder()):
        entry._fill_portal_scene(builder, "projection")
        builder.tris[0]["v0_e"] = np.asarray(builder.tris[0]["v0"]) \
            + (0.0, 0.0, 0.5)
        moved.append(builder)
    js = moved[0].build()
    ts = moved[1].build("cpu")
    assert js.has_motion and ts.has_motion
    assert js.fused_profile is None and ts.fused_profile is None
    # the gate refuses a scene with motion even with a profile
    assert not fused_path.eligible(dataclasses.replace(
        ts, fused_profile=scene.fused_profile), cfg)
    rows = ik.pack_scene(ts, motion=True)[0]
    assert rows.shape == (ts.n_tri, 18)
    assert rows[0, 9:12].tolist() == [0.0, 0.0, 0.5]
    assert not rows[1:, 9:].any()


def _fori_loop(lo, hi, body, init):
    for k in range(lo, hi):
        init = body(k, init)
    return init


def _pass(scene_j, cam_j, scene_t, cam_t, integrator, spp=1, max_depth=3,
          seed=2):
    """One render_pass of both packages over the whole film (box filter,
    independent sampler), pbrt_tpu op by op (its jitted pass unwrapped,
    its loops run in Python): per pixel the lane sums of ``spp``
    lanes."""
    w, h = cam_t.resolution
    jcfg = jrender.RenderConfig(integrator=integrator, max_depth=max_depth,
                                seed=seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "fori_loop", _fori_loop)
        img_j = np.asarray(jrender.render_pass.__wrapped__(
            scene_j, cam_j, jfilm.make_filter("box"), jcfg, w, h, spp,
            jnp.uint32(0)))
    tcfg = trender.RenderConfig(integrator=integrator, max_depth=max_depth,
                                seed=seed)
    img_t = trender.render_pass(scene_t, cam_t, tfilm.make_filter("box"),
                                tcfg, w, h, spp, 0, "cpu").numpy()
    return img_j, img_t


def _lanes_off(a, b):
    bad = ~np.isclose(a, b, rtol=2e-5, atol=1e-6).all(-1)
    return int(bad.sum()), bad.size


@pytest.fixture(scope="module")
def dofmotion():
    js, jc, _ = jload_pbrt(DOFMOTION)
    return js, jc, bridge.scene_from_jax(js), bridge.camera_from_jax(jc)


def test_dofmotion_path_pass_lane_for_lane(dofmotion):
    """A whole 96² × 1-spp `path` pass of dofmotion (each lane's shutter
    time through every query, the moving box through the motion twin of
    kernel 2) against pbrt_tpu's, lane for lane."""
    js, jc, ts, tc = dofmotion
    img_j, img_t = _pass(js, jc, ts, tc, "path")
    off, n = _lanes_off(img_t, img_j)
    assert off <= LANES_OFF * n, f"{off} of {n} lanes off"
    assert img_t.mean() > 0.01
    # the moving box blurs: shutter time 0 gives another image
    st = dataclasses.replace(ts, has_motion=False)
    img_0 = trender.render_pass(st, tc, tfilm.make_filter("box"),
                                trender.RenderConfig(max_depth=3, seed=2),
                                96, 96, 1, 0, "cpu").numpy()
    assert _lanes_off(img_0, img_t)[0] > 50


@pytest.mark.parametrize("integrator", ["ao", "whitted", "volpath"])
def test_time_reaches_the_integrators_as_in_pbrt_tpu(dofmotion, integrator):
    """`ao` and `whitted` take each lane's shutter time (as `path`,
    `direct` and `mypath`); `volpath`, like pbrt_tpu's hero, bdpt, mlt and
    sppm, ignores it and sees the scene at shutter time 0. Each 96² ×
    1-spp pass of dofmotion lane for lane against pbrt_tpu's."""
    js, jc, ts, tc = dofmotion
    img_j, img_t = _pass(js, jc, ts, tc, integrator, max_depth=2)
    off, n = _lanes_off(img_t, img_j)
    assert off <= LANES_OFF * n, f"{off} of {n} lanes off"
    assert img_t.mean() > 0.005


def test_dofmotion_matches_reference_binary():
    """tests/test_oracle.py's call (64 spp, seed 2, the independent
    sampler, the file's max depth) on the port's CPU twins, with its
    limits: md < 0.01, block rel-L1 < 0.03."""
    ref = imageio.read_pfm(os.path.join(ORACLE, "dofmotion_ref.pfm"))
    scene, cam, opts = tparser.load_pbrt(DOFMOTION, device="cpu")
    img = trender.render(scene, cam, spp=64, integrator="path",
                         max_depth=opts["max_depth"], seed=2,
                         device="cpu").numpy()
    ma, mb = float(img.mean()), float(ref.mean())
    md = abs(ma - mb) / max(min(ma, mb), 1e-9)
    k = 16
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    da = img[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    db = ref[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    bl = float(np.abs(da - db).sum() / max(db.sum(), 1e-9))
    assert md < 0.01, f"dof+motion mean delta {md:.4f}"
    assert bl < 0.03, f"dof+motion block rel-L1 {bl:.4f}"
