"""The port's counterparts of pbrt_tpu's public helpers that no render
path calls: the transform builders, the vector, bounds, sampling and
spectrum helpers, the all-pairs shape tests, the full-distribution
Beckmann and anisotropic TR samplers, the per-lane radical inverse and
the SPPM scan bound. Each group holds the port against pbrt_tpu (run op
by op, no jitted program) on seeded numpy inputs: exact where both run
the same float operations in the same order, else within rtol 1e-6 and
the stated atol, for these reasons:

- XLA's CPU sin, cos, exp, log1p and sqrt differ from torch's by an ulp
  now and then (torch's float32 sqrt is not correctly rounded on the
  CPU); atol 1e-6 covers results near 0 from a cancelling sum;
- XLA's CPU dot rounds a 3-term product in an order that depends on the
  operands' shapes (one row and 1,000 rows differ), so ``rgb_to_xyz``
  matches to rtol 1e-6, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import samplers as jsamplers
from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.core import spectrum as jspectrum
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core import vecmath as jvecmath
from pbrt_tpu.integrators import sppm as jsppm
from pbrt_tpu.scene import materials as jmat
from pbrt_tpu.scene import shapes as jshapes
from pbrt_tpu_torch import samplers as tsamplers
from pbrt_tpu_torch.core import sampling as tsampling
from pbrt_tpu_torch.core import spectrum as tspectrum
from pbrt_tpu_torch.core import transform as ttransform
from pbrt_tpu_torch.core import vecmath as tvecmath
from pbrt_tpu_torch.integrators import sppm as tsppm
from pbrt_tpu_torch.scene import materials as tmat
from pbrt_tpu_torch.scene import shapes as tshapes

N = 2048


def _rng(k):
    return np.random.default_rng(1000 + k)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _same(got, want, rtol=0.0, atol=0.0):
    """got (torch or numpy) against pbrt_tpu's want, elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _transforms():
    cases = [("identity", ()), ("translate", ((0.5, -2.0, 3.25),)),
             ("scale", ((2.0, 0.5, -4.0),)), ("scale", (3.0,)),
             ("rotate", (37.5, (1.0, 2.0, -0.5))), ("rotate_x", (90.0,)),
             ("rotate_y", (-12.0,)), ("rotate_z", (200.0,)),
             ("perspective", (45.0, 0.01, 1000.0)),
             ("orthographic", (0.0, 1.0)), ("orthographic", (-2.0, 5.0))]
    for name, args in cases:
        want = getattr(jtransform, name)(*args)
        got = getattr(ttransform, name)(*args, device="cpu")
        assert got.m.device.type == "cpu"
        _same(got.m, want.m)
        _same(got.m_inv, want.m_inv)
    # a builder's Transform composes and applies as the port's does
    t = ttransform.translate((1, 2, 3)) @ ttransform.rotate_y(30.0)
    p = torch.tensor([[0.5, -1.0, 2.0]])
    _same((t @ t.inverse()).apply_point(p), p.numpy(), atol=1e-6)


def _vecmath():
    rng = _rng(1)
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    t = rng.random(N).astype(np.float32)
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    ta, tb, tt = torch.tensor(a), torch.tensor(b), torch.tensor(t)
    _same(tvecmath.distance(ta, tb), jvecmath.distance(ja, jb), rtol=1e-6)
    _same(tvecmath.distance_squared(ta, tb),
          jvecmath.distance_squared(ja, jb))
    _same(tvecmath.lerp(tt[:, None], ta, tb),
          jvecmath.lerp(jt[:, None], ja, jb))
    _same(tvecmath.lerp(0.25, ta, tb), jvecmath.lerp(0.25, ja, jb))
    cos_t = rng.uniform(-1, 1, N).astype(np.float32)
    sin_t = np.sqrt(1 - cos_t * cos_t).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    x, y, z = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    _same(tvecmath.spherical_direction(*(torch.tensor(v) for v in
                                         (sin_t, cos_t, phi))),
          jvecmath.spherical_direction(*(jnp.asarray(v) for v in
                                         (sin_t, cos_t, phi))),
          rtol=1e-6, atol=1e-6)
    _same(tvecmath.spherical_direction(
        *(torch.tensor(v) for v in (sin_t, cos_t, phi, x, y, z))),
        jvecmath.spherical_direction(
            *(jnp.asarray(v) for v in (sin_t, cos_t, phi, x, y, z))),
        rtol=1e-6, atol=1e-6)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    lo2 = rng.normal(size=(N, 3)).astype(np.float32)
    hi2 = lo2 + rng.random((N, 3)).astype(np.float32)
    jb1 = jvecmath.Bounds3(jnp.asarray(lo), jnp.asarray(hi))
    jb2 = jvecmath.Bounds3(jnp.asarray(lo2), jnp.asarray(hi2))
    tb1 = tvecmath.Bounds3(torch.tensor(lo), torch.tensor(hi))
    tb2 = tvecmath.Bounds3(torch.tensor(lo2), torch.tensor(hi2))
    for f in ("diagonal", "surface_area", "centroid"):
        _same(getattr(tb1, f)(), getattr(jb1, f)())
    ju, tu = jvecmath.bounds_union(jb1, jb2), tvecmath.bounds_union(tb1, tb2)
    _same(tu.lo, ju.lo)
    _same(tu.hi, ju.hi)
    _same(tu.surface_area(), ju.surface_area())


def _sampling():
    rng = _rng(2)
    assert tsampling.INV_2PI == jsampling.INV_2PI
    f = rng.random(37).astype(np.float32)
    f[[3, 9, 10]] = 0.0
    rows = rng.random((64, 37)).astype(np.float32)
    rows[5] = 0.0                       # a zero-integral row: uniform pmf
    idx = rng.integers(0, 37, N)
    # the pdf of pbrt_tpu's tables (XLA's CPU cumsum of a batch of rows
    # sums in another order than torch's; the tables are not under test)
    for tab, n in ((f, N), (np.zeros(37, np.float32), N), (rows, 64)):
        jd = jsampling.make_distribution_1d(jnp.asarray(tab))
        td = tsampling.Distribution1D(*(torch.tensor(np.asarray(v)) for v in
                                        (jd.func, jd.cdf, jd.func_int)))
        _same(tsampling.distribution_1d_discrete_pdf(
            td, torch.tensor(idx[:n])),
            jsampling.distribution_1d_discrete_pdf(jd, jnp.asarray(idx[:n])))
    c = rng.uniform(-1, 1, N).astype(np.float32)
    _same(tsampling.cosine_hemisphere_pdf(torch.tensor(c)),
          jsampling.cosine_hemisphere_pdf(jnp.asarray(c)))
    fp, gp = (rng.random(N).astype(np.float32) for _ in range(2))
    fp[:16] = gp[:16] = 0.0              # both pdfs 0: the clamp
    for nf, ng in ((1, 1), (1, 3), (2.0, 0.5)):
        _same(tsampling.balance_heuristic(nf, torch.tensor(fp), ng,
                                          torch.tensor(gp)),
              jsampling.balance_heuristic(nf, jnp.asarray(fp), ng,
                                          jnp.asarray(gp)))


def _spectrum():
    rng = _rng(3)
    lam = np.concatenate([np.linspace(360.0, 830.0, 941),
                          rng.uniform(400, 700, 1000)]).astype(np.float32)
    _same(tspectrum.cie_xyz(torch.tensor(lam)),
          jspectrum.cie_xyz(jnp.asarray(lam)), rtol=1e-6, atol=1e-6)
    lam64 = lam.astype(np.float64)
    _same(tspectrum.cie_xyz(lam64), jspectrum.cie_xyz(lam64))
    rgb = (rng.random((N, 3)) * 4 - 1).astype(np.float32)
    want = jspectrum.rgb_to_xyz(jnp.asarray(rgb))
    _same(tspectrum.rgb_to_xyz(torch.tensor(rgb)), want, rtol=1e-6,
          atol=1e-6)
    _same(tspectrum.rgb_to_xyz(rgb), want, rtol=1e-6, atol=1e-6)
    # a round trip through the port's own XYZ → RGB
    back = tspectrum.xyz_to_rgb(tspectrum.rgb_to_xyz(rgb))
    np.testing.assert_allclose(back, rgb, atol=2e-6)


def _rays(rng, n):
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.random(n) < 0.25, rng.uniform(0.1, 2.0, n),
                    np.inf).astype(np.float32)
    return o, d, tmax


def _check_hits(got, want, rtol):
    """Equal hit masks; every float output equal (within rtol) on the
    pairs that hit."""
    *tg, hg = (g.numpy() for g in got)
    *tw, hw = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(hg, hw)
    assert 0.02 < hw.mean() < 0.98 and hw.any(-1).mean() < 1.0
    for a, b in zip(tg, tw):
        if rtol:
            np.testing.assert_allclose(a[hw], b[hw], rtol=rtol)
        else:
            np.testing.assert_array_equal(a, b)


def _shapes():
    rng = _rng(4)
    R = 512
    o, d, tmax = _rays(rng, R)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    to, td, tt = torch.tensor(o), torch.tensor(d), torch.tensor(tmax)
    # triangles, with a duplicated one (a tie: both hit at the same t)
    # and a degenerate one (never hit)
    v0, v1, v2 = (rng.uniform(-0.8, 0.8, (24, 3)).astype(np.float32)
                  for _ in range(3))
    v0[5], v1[5], v2[5] = v0[4], v1[4], v2[4]
    v2[7] = v0[7] + 2.0 * (v1[7] - v0[7])
    jv, tv = [jnp.asarray(v) for v in (v0, v1, v2)], [
        torch.tensor(v) for v in (v0, v1, v2)]
    got = tshapes.intersect_triangles(to, td, tt, *tv)
    want = jshapes.intersect_triangles(jo, jd, jt, *jv)
    _check_hits(got, want, 0.0)
    hw = np.asarray(want[3])
    assert hw[:, 4].any() and (hw[:, 4] == hw[:, 5]).all()
    assert not hw[:, 7].any()
    assert (np.isfinite(tmax) & ~hw.any(-1)).any()      # a cut-off ray
    # per-ray vertices (motion-blurred triangles at each ray's time)
    dv = rng.normal(scale=0.05, size=(R, 24, 3)).astype(np.float32)
    jvr = [jnp.asarray(v[None] + dv) for v in (v0, v1, v2)]
    tvr = [torch.tensor(v[None] + dv) for v in (v0, v1, v2)]
    _check_hits(tshapes.intersect_triangles(to, td, tt, *tvr),
                jshapes.intersect_triangles(jo, jd, jt, *jvr), 0.0)
    # spheres, one of them twice
    c = rng.uniform(-0.7, 0.7, (12, 3)).astype(np.float32)
    r = rng.uniform(0.05, 0.4, 12).astype(np.float32)
    c[3], r[3] = c[2], r[2]
    got = tshapes.intersect_spheres(to, td, tt, torch.tensor(c),
                                    torch.tensor(r))
    want = jshapes.intersect_spheres(jo, jd, jt, jnp.asarray(c),
                                     jnp.asarray(r))
    _check_hits(got, want, 1e-6)
    np.testing.assert_array_equal(np.asarray(want[1])[:, 2],
                                  np.asarray(want[1])[:, 3])
    # aaplanes on each axis, one of them twice
    ax = np.array([0, 1, 2] * 6, np.int32)
    lo = rng.uniform(-0.8, 0.2, (18, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 0.6, (18, 3)).astype(np.float32)
    lo[10], hi[10] = lo[7], hi[7]
    ax[10] = ax[7]
    got = tshapes.intersect_aaplanes(to, td, tt, torch.tensor(lo),
                                     torch.tensor(hi), torch.tensor(ax))
    want = jshapes.intersect_aaplanes(jo, jd, jt, jnp.asarray(lo),
                                      jnp.asarray(hi), jnp.asarray(ax))
    _check_hits(got, want, 0.0)
    for g, w in zip(tshapes.aaplane_corners(torch.tensor(lo),
                                            torch.tensor(hi),
                                            torch.tensor(ax)),
                    jshapes.aaplane_corners(jnp.asarray(lo), jnp.asarray(hi),
                                            jnp.asarray(ax))):
        _same(g, w)


def _microfacets():
    rng = _rng(5)
    wo = _unit(rng, N)
    u = rng.random((N, 2)).astype(np.float32)
    u[:8, 0] = 0.0
    u[8:16, 0] = 1.0 - 2.0 ** -24         # the 0.99999 clamp
    alpha = rng.uniform(0.02, 1.0, N).astype(np.float32)
    ay = rng.uniform(0.02, 1.0, N).astype(np.float32)
    jwo, ju, ja, jay = (jnp.asarray(v) for v in (wo, u, alpha, ay))
    two, tu, ta, tay = (torch.tensor(v) for v in (wo, u, alpha, ay))
    wh_j = jmat.beck_sample_wh_full(jwo, ju, ja)
    wh_t = tmat.beck_sample_wh_full(two, tu, ta)
    _same(wh_t, wh_j, rtol=1e-6, atol=1e-6)
    assert (np.sign(np.asarray(wh_j)[:, 2]) == np.sign(wo[:, 2])).all()
    # the pdf on the same half vectors (pbrt_tpu's)
    _same(tmat.beck_pdf_wh_full(two, torch.tensor(np.asarray(wh_j)), ta),
          jmat.beck_pdf_wh_full(jwo, wh_j, ja), rtol=1e-6, atol=1e-6)
    _same(tmat.tr_sample_wh_aniso(two, tu, ta, tay),
          jmat.tr_sample_wh_aniso(jwo, ju, ja, jay), rtol=1e-6, atol=1e-6)
    # isotropic: the render's tr_sample_wh is the same step
    _same(tmat.tr_sample_wh(two, tu, ta),
          tmat.tr_sample_wh_aniso(two, tu, ta, ta))


def _samplers_and_sppm():
    rng = _rng(6)
    base_idx = rng.integers(-3, 80, N).astype(np.int32)   # clipped ends
    a = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    _same(tsamplers.radical_inverse(torch.tensor(base_idx),
                                    torch.tensor(a.astype(np.int64))),
          jsamplers.radical_inverse(jnp.asarray(base_idx), jnp.asarray(a)))
    assert tsppm.MAX_PER_CELL == jsppm.MAX_PER_CELL


GROUPS = {"transform": _transforms, "vecmath": _vecmath,
          "sampling": _sampling, "spectrum": _spectrum, "shapes": _shapes,
          "microfacets": _microfacets,
          "samplers_sppm": _samplers_and_sppm}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_helpers_match_jax(group):
    GROUPS[group]()
