"""Cubic Bézier curves against pbrt_tpu: the span test, the tiled fold,
the hit frame, ``finalize_hit`` on both query paths, the ribbon
tessellator, whole passes and the curves oracle file.

Scenes are parsed by both packages from one text, or built by pbrt_tpu
and carried across with ``bridge.scene_from_jax``. pbrt_tpu's curve test
is plain jnp (no Pallas kernel takes a curve), run eagerly here except in
the two passes, which are pbrt_tpu's jitted ``render_pass``.

Tolerances. Hits equal but for grazing pairs, at most 0.5% of the hits
(found: none of 1,864 / 1,482 / 1,650 in the seeded sets); t rtol 1e-5
(XLA contracts the span's lerps into multiply-adds, the port rounds every
operation; found: 2e-6 absolute at t ≈ 4); u atol 1e-5; v atol 1e-4 (v
divides the chord's distance by the half width, so the t error grows by
1/width; found 1.8e-5). The hit frame's vectors atol 1e-5. A pass's
radiance per lane rtol 1e-4 / atol 1e-5, as tests/test_torch_oracle.py's
file pass (found: every lane). The tiled fold is held to the untiled
family best bit for bit. The oracle file at tests/test_oracle.py's call
and limits (md < 0.08, block rel-L1 < 0.08; found 0.0435 / 0.0434).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.frontend import parse_pbrt_string as jparse
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import shapes as jshapes
from pbrt_tpu.scene import tessellate as jtess
from pbrt_tpu_torch.frontend import load_pbrt, parse_pbrt_string
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import shapes as tshapes
from pbrt_tpu_torch.scene import tessellate as ttess
from pbrt_tpu_torch.utils import imageio

# each xdist worker's share of the cores
import test_torch_intersect  # noqa: F401
from test_torch_grad import finite_sqrt_gradient
from test_torch_oracle import _block_rel_l1, _mean_delta

jrender = importlib.import_module("pbrt_tpu.integrators.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
CURVES = os.path.join(ORACLE, "curves_oracle.pbrt")
GRAZING_SHARE = 0.005


def _curves(kind, n=7, seed=0):
    """Seeded control points, widths and (for ribbons) unit normals at
    both ends: ``cylinder`` and ``flat`` curves carry no normals."""
    rs = np.random.RandomState(seed)
    cp = rs.uniform(-1, 1, (n, 4, 3)).astype(np.float32)
    w = rs.uniform(0.05, 0.3, (n, 2)).astype(np.float32)
    if kind != "ribbon":
        return cp, w, None
    nr = rs.normal(size=(n, 2, 3)).astype(np.float32)
    nr /= np.linalg.norm(nr, axis=-1, keepdims=True)
    nr[::3] = 0.0      # a flat row among the ribbons
    return cp, w, nr


def _rays(n=4000, seed=1):
    rs = np.random.RandomState(seed)
    o = (rs.uniform(-2, 2, (n, 3)) + (0, 0, -4)).astype(np.float32)
    d = rs.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::5] = 4.0
    return o, d, tmax


def _both(*arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("kind", ("cylinder", "flat", "ribbon"))
def test_intersect_curves_matches_jax(kind):
    cp, w, nr = _curves(kind, seed={"cylinder": 0, "flat": 2,
                                    "ribbon": 3}[kind])
    (jo, jd, jt, jc, jw, jn), (to, td, tt, tc, tw, tn) = _both(
        *_rays(), cp, w, nr)
    a = [np.asarray(x) for x in jshapes.intersect_curves(jo, jd, jt, jc, jw,
                                                         jn)]
    b = [x.numpy() for x in tshapes.intersect_curves(to, td, tt, tc, tw, tn)]
    off = int((a[3] != b[3]).sum())
    assert a[3].sum() > 1000 and off <= GRAZING_SHARE * a[3].sum(), off
    both = a[3] & b[3]
    np.testing.assert_allclose(b[0][both], a[0][both], rtol=1e-5)
    np.testing.assert_allclose(b[1][both], a[1][both], atol=1e-5)
    np.testing.assert_allclose(b[2][both], a[2][both], atol=1e-4)
    assert (b[0][~b[3]] == tshapes.BIG).all()


def test_tiled_fold_equals_untiled():
    """Tiles of 1 and 3 of the 8 curves, and the size ``curve_tile``
    picks (all 8), give pbrt_tpu's family best over the untiled all-pairs
    test, computed by the port, bit for bit; the any-hit mask is the
    tiles' OR."""
    cp, w, nr = _curves("ribbon", n=8, seed=4)
    o, d, tmax = (torch.as_tensor(x) for x in _rays(n=2000, seed=5))
    cp, w, nr = (torch.as_tensor(x) for x in (cp, w, nr))
    t, u, v, h = tshapes.intersect_curves(o, d, tmax, cp, w, nr)
    tb, idx = torch.where(h, t, tshapes.BIG).min(dim=-1)
    at = idx[:, None]
    want = (tb, idx, u.gather(-1, at)[:, 0], v.gather(-1, at)[:, 0])
    assert h.sum() > 500
    for tile in (1, 3, None):
        got = tshapes.closest_curves(o, d, tmax, cp, w, nr, tile=tile)
        assert all(torch.equal(g, x) for g, x in zip(got, want)), tile
    assert tshapes.curve_tile(2000, 8) == 8
    assert torch.equal(tshapes.any_curves(o, d, tmax, cp, w, nr, tile=3),
                       h.any(-1))
    assert tshapes.curve_tile(1 << 21, 128) == 8
    assert tshapes.curve_tile(1 << 25, 128) == 1


def test_curve_hit_frame_matches_jax():
    cp, w, nr = _curves("ribbon", n=64, seed=6)
    rs = np.random.RandomState(7)
    u = rs.uniform(0, 1, 64).astype(np.float32)
    v = rs.uniform(0, 1, 64).astype(np.float32)
    d = rs.normal(size=(64, 3)).astype(np.float32)
    o = np.zeros((64, 3), np.float32)
    for rows in (None, nr):
        (jo, jd, jc, jw, ju, jv, jn), (to, td, tc, tw, tu, tv, tn) = _both(
            o, d, cp, w, u, v, rows)
        a = jshapes.curve_hit_frame(jo, jd, jc, jw, ju, jv, jo, nrows=jn)
        b = tshapes.curve_hit_frame(to, td, tc, tw, tu, tv, to, nrows=tn)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)


_RIBBON = """Shape "curve" "string type" "ribbon"
  "point P" [-0.3 0.1 -0.5  -0.1 0.8 -0.4  0.2 0.9 -0.3  0.4 0.3 -0.2]
  "normal N" [0 0 -1  0.3 0 -1] "float width" [0.15]
"""


def _curves_text(res=24, heightfield=False):
    """curves_oracle.pbrt cut to ``res``² with a ribbon added; with
    ``heightfield``, the ground is a 20 × 20 heightfield (722 triangles:
    a BVH scene) under a 4-spp film."""
    with open(CURVES) as f:
        text = f.read()
    full = '"integer xresolution" [96] "integer yresolution" [96]'
    assert full in text
    text = text.replace(full, f'"integer xresolution" [{res}] '
                              f'"integer yresolution" [{res}]')
    text = text.replace("WorldEnd", _RIBBON + "WorldEnd")
    if heightfield:
        ground = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
                  '  "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]')
        assert ground in text
        rs = np.random.RandomState(8)
        pz = " ".join(f"{z:.4f}" for z in rs.uniform(0, 0.05, 400))
        text = text.replace(ground, (
            "AttributeBegin\nTranslate -3 0 3\nScale 6 1 6\n"
            "Rotate -90 1 0 0\n"
            'Shape "heightfield" "integer nu" [20] "integer nv" [20] '
            f'"float Pz" [{pz}]\nAttributeEnd'))
    return text


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for key, hf in (("brute", False), ("bvh", True)):
        text = _curves_text(heightfield=hf)
        js, jc, jo = jparse(text, base_dir=ORACLE)
        ts, tc, to = parse_pbrt_string(text, base_dir=ORACLE, device="cpu")
        assert ts.n_crv == 3 and (ts.bvh is not None) == hf
        assert ts.geom.crv_n is not None and js.geom.crv_n is not None
        out[key] = (js, jc, jo, ts, tc, to)
    return out


@pytest.mark.parametrize("path", ("brute", "bvh"))
def test_finalize_hit_on_curves_matches_jax(scenes, path):
    """The Hit records of both query paths: the brute-force path hands
    the fold's (u, v) to ``finalize_hit`` (pbrt_tpu's cache), the BVH path
    rescans the hit curve (bound t + 1e-3), as pbrt_tpu's do. Prim ids
    equal but for grazing lanes; p, the normals, uv and dpdu / dpdv at
    atol 1e-4 on the curve hits; the any-hit masks equal but for
    grazing lanes."""
    js, jc, _, ts, tc, _ = scenes[path]
    rs = np.random.RandomState(9)
    n = 6000
    target = np.stack([rs.uniform(-1.0, 1.2, n), rs.uniform(0.0, 1.2, n),
                       rs.uniform(-0.6, 0.4, n)], -1).astype(np.float32)
    o = np.tile(np.float32([[0.1, 1.3, -3.2]]), (n, 1))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    (jo_, jd, jt), (to_, td, tt) = _both(o, d, tmax)
    jh = jisect.intersect(js, jo_, jd, jt)
    th = tisect.intersect(ts, to_, td, tt)
    jp, tp = np.asarray(jh.prim_id), th.prim_id.numpy()
    base = ts.n_tri + ts.n_sph + ts.n_pln + ts.n_dsk
    crv = (jp >= base) & (tp == jp)
    assert crv.sum() > 300 and (jp != tp).sum() <= 10
    for k in ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(th, k).numpy()[crv],
                                   np.asarray(getattr(jh, k))[crv],
                                   atol=1e-4, err_msg=k)
    seg = np.where(np.arange(n) % 2 == 0, 3.5, np.inf).astype(np.float32)
    occ_j = np.asarray(jisect.intersect_p(js, jo_, jd, jnp.asarray(seg)))
    occ_t = tisect.intersect_p(ts, to_, td, torch.as_tensor(seg)).numpy()
    assert (occ_j != occ_t).sum() <= 10 and occ_t.sum() > 300


def test_curve_t_gradient_matches_jax(scenes):
    """A curve hit's t carries pbrt_tpu's gradient (``_attach_t``): the
    derivative of the summed t of the curve hits with respect to the
    rays' origins and directions against ``jax.grad`` through pbrt_tpu's
    brute-force query, rtol 1e-3 / atol 1e-4. pbrt_tpu's own gradient is
    NaN (its clamped square roots give 0 · ∞ on the rays that miss the
    sphere light), so its reference is taken with √'s derivative set to 0
    where the argument is ≤ 0, as tests/test_torch_grad.py takes it."""
    js, _, _, ts, _, _ = scenes["brute"]
    rs = np.random.RandomState(10)
    n = 512
    target = np.stack([rs.uniform(-0.8, 1.0, n), rs.uniform(0.1, 1.0, n),
                       rs.uniform(-0.5, 0.3, n)], -1).astype(np.float32)
    o = np.tile(np.float32([[0.1, 1.3, -3.2]]), (n, 1))
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    tmax = jnp.full(n, jnp.inf)
    base = ts.n_tri + ts.n_sph + ts.n_pln + ts.n_dsk
    prim = np.asarray(jisect.intersect(js, jnp.asarray(o), jnp.asarray(d),
                                       tmax).prim_id)
    on = jnp.asarray(prim >= base)
    assert int(on.sum()) > 50

    def jsum(oo, dd):
        h = jisect.intersect(js, oo, dd, tmax)
        return jnp.sum(jnp.where(on, h.t, 0.0))
    with finite_sqrt_gradient():
        go, gd = jax.jit(jax.grad(jsum, argnums=(0, 1)))(jnp.asarray(o),
                                                         jnp.asarray(d))
    to_ = torch.as_tensor(o).requires_grad_()
    td = torch.as_tensor(d).requires_grad_()
    th = tisect.intersect(ts, to_, td, torch.full((n,), float("inf")))
    torch.where(torch.as_tensor(prim >= base), th.t, 0.0).sum().backward()
    np.testing.assert_allclose(to_.grad.numpy(), np.asarray(go), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=1e-3,
                               atol=1e-4)


def test_tessellate_curve_matches_jax():
    cp = [(0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0)]
    bent = np.random.RandomState(11).uniform(-1, 1, (4, 3))
    for pts, n_seg in ((cp, 8), (bent, 16)):
        a = jtess.tessellate_curve(pts, 0.1, 0.05, n_seg=n_seg)
        b = ttess.tessellate_curve(pts, 0.1, 0.05, n_seg=n_seg)
        assert b[0].shape == (2 * (n_seg + 1), 3) and len(b[1]) == 2 * n_seg
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("path", ("brute", "bvh"))
def test_curves_pass_matches_jax(scenes, path):
    """One halton ``render_pass`` (24², 4 spp, the file's max_depth 3) of
    the curves file with a ribbon added, on the brute-force path and with
    a heightfield ground under a BVH, lane for lane against pbrt_tpu's
    jitted pass."""
    js, jc, jo, ts, tc, to = scenes[path]
    a = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=jo["max_depth"]),
        24, 24, 4, jnp.asarray(0, jnp.uint32)))
    b = trender.render_pass(
        ts, tc, tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=to["max_depth"]),
        24, 24, 4, 0, device="cpu")
    assert float(a.mean()) > 0.1
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)


def test_curves_oracle_matches_reference_binary():
    """tests/test_oracle.py's call (64 spp, seed 2, `path`, the file's
    max_depth, the render's default sampler) and limits."""
    scene, cam, opts = load_pbrt(CURVES, device="cpu")
    assert scene.n_crv == 2 and scene.geom.crv_n is None
    img = trender.render(scene, cam, spp=64, integrator="path",
                         max_depth=opts["max_depth"], seed=2,
                         device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, "curves_ref.pfm"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < 0.08, f"curves mean delta {md:.4f}"
    assert bl < 0.08, f"curves block rel-L1 {bl:.4f}"
