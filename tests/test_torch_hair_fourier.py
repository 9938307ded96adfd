"""The hair and Fourier materials against pbrt_tpu: the hair BSDF's f, pdf
and sampling, the absorption helpers, the SCATFUN reader and writer, the
Fourier evaluation, the HAIR and FOURIER rows through ``bsdf_f``,
``bsdf_pdf`` and ``bsdf_sample``, and a `path` pass of a scene with a hair
curve and a Fourier sphere, lane for lane.

Inputs are seeded with numpy, every shape parameter a per-lane row (the
gathered material rows' form). pbrt_tpu runs eagerly but for its pass
(its jitted ``render_pass``). The Fourier tables are written by the
port's ``write_bsdf`` into a temporary directory: the Lambertian table of
tests/test_fourier.py (one channel) and a seeded three-channel table with
five Fourier terms.

Tolerances. Hair f and pdf rtol 1e-4 / atol 1e-6 (XLA's and torch's
float32 exp, log, sinh and asin differ in the last bits, and the narrow
lobes' exp(−1/v) scales them by up to 1/v; found 3.1e-5). A sample's wi
atol 1e-4 (found 7.1e-5) on all but 0.2% of the lanes (a u_p within
rounding of a lobe CDF's edge picks another lobe; found none); its f and
pdf rtol 2e-3, being evaluated at that wi, which a narrow lobe's
exp(cos·cos/v) turns into a relative change of up to |Δwi|/v (found
5.8e-4 and 1.6e-4). The absorption helpers rtol 1e-6. Fourier values
rtol 1e-4 / atol 1e-6 (the green channel is a difference of three
series; found 3.2e-5). The BSDF rows as their families. A pass's
radiance per lane rtol 1e-4 / atol 1e-5 (found: every lane).
"""

import importlib
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import fourier as jfourier
from pbrt_tpu.scene import hair as jhair
from pbrt_tpu.scene import materials as jmat
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import fourier as tfourier
from pbrt_tpu_torch.scene import hair as thair
from pbrt_tpu_torch.scene import materials as tmat

# each xdist worker's share of the cores
import test_torch_intersect  # noqa: F401

jrender = importlib.import_module("pbrt_tpu.integrators.render")

N = 4096


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _hair_lanes(seed=0, n=N):
    """(wo, wi, h, sigma_a, beta_m, beta_n, alpha, eta), per lane; beta_m
    spans both of Mp's branches (v ≤ 0.1 and above)."""
    rs = np.random.RandomState(seed)
    f = np.float32
    return (_unit(rs, n), _unit(rs, n), rs.uniform(-1, 1, n).astype(f),
            rs.uniform(0, 2, (n, 3)).astype(f),
            rs.uniform(0.08, 0.9, n).astype(f),
            rs.uniform(0.1, 0.9, n).astype(f),
            rs.uniform(0, 5, n).astype(f), rs.uniform(1.3, 1.8, n).astype(f))


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def _close(b, a, rtol=1e-4, atol=1e-6, what=""):
    np.testing.assert_allclose(b.numpy() if isinstance(b, torch.Tensor)
                               else b, np.asarray(a), rtol=rtol, atol=atol,
                               err_msg=what)


def test_hair_f_and_pdf_match_jax():
    lanes = _hair_lanes(0)
    wo, wi, h, sa, bm, bn, al, eta = lanes
    a_f = jhair.hair_f(*_j(*lanes))
    a_p = jhair.hair_pdf(*_j(*lanes))
    b_f = thair.hair_f(*_t(*lanes))
    b_p = thair.hair_pdf(*_t(*lanes))
    assert float(np.asarray(a_f).max()) > 1.0
    _close(b_f, a_f, what="f")
    _close(b_p, a_p, what="pdf")
    # the scalar shape parameters of the furnace tests
    a = jhair.hair_f(*_j(wo, wi, h, sa), beta_m=0.25, beta_n=0.3, alpha=2.0)
    b = thair.hair_f(*_t(wo, wi, h, sa), beta_m=0.25, beta_n=0.3, alpha=2.0)
    _close(b, a, what="f, scalar shape")
    _close(thair.hair_ap_pdf(*_t(wo, h, sa, eta)),
           jhair.hair_ap_pdf(*_j(wo, h, sa, eta)), what="ap pdf")


def _same_lobe(wi_a, wi_b):
    """The lanes whose sampled wi agree to 1e-4, all but at most 0.2%."""
    same = np.abs(np.asarray(wi_a) - wi_b.numpy()).max(-1) < 1e-4
    assert (~same).sum() <= 0.002 * N, int((~same).sum())
    return same


def test_hair_sample_matches_jax():
    wo, _, h, sa, bm, bn, al, eta = _hair_lanes(1)
    u = np.random.RandomState(2).uniform(0, 1, (3, N)).astype(np.float32)
    a = jhair.hair_sample(*_j(wo, h, sa, u[0], u[1], u[2]), beta_m=bm,
                          beta_n=bn, alpha=al, eta=eta)
    b = thair.hair_sample(*_t(wo, h, sa, u[0], u[1], u[2]),
                          beta_m=torch.as_tensor(bm),
                          beta_n=torch.as_tensor(bn),
                          alpha=torch.as_tensor(al),
                          eta=torch.as_tensor(eta))
    same = _same_lobe(a[0], b[0])
    _close(b[1].numpy()[same], np.asarray(a[1])[same], rtol=2e-3, what="f")
    _close(b[2].numpy()[same], np.asarray(a[2])[same], rtol=2e-3,
           what="pdf")


def test_hair_white_furnace():
    """tests/test_hair.py's importance-sampled white furnace on the port:
    sigma_a = 0 hair scatters all energy, E[f·|cos|/pdf] = 1 (atol 0.01)."""
    n = 100_000
    rs = np.random.RandomState(7)
    wo = torch.tensor([[0.3, 0.5, 0.81]]) / math.sqrt(0.3 ** 2 + 0.5 ** 2
                                                      + 0.81 ** 2)
    u = torch.as_tensor(rs.rand(3, n).astype(np.float32))
    wi, f, pdf = thair.hair_sample(wo.expand(n, 3), torch.full((n,), 0.3),
                                   torch.zeros(n, 3), u[0], u[1], u[2],
                                   beta_m=0.25, beta_n=0.3, alpha=2.0)
    est = (f * wi[:, 2:3].abs() / pdf.clamp_min(1e-12)[:, None]).mean(0)
    np.testing.assert_allclose(est.numpy(), 1.0, atol=0.01)


def test_sigma_a_helpers_match_jax():
    for ce, cp in ((1.3, 0.0), (0.2, 0.8), (8.0, 2.5)):
        _close(thair.sigma_a_from_concentration(ce, cp),
               jhair.sigma_a_from_concentration(ce, cp), rtol=1e-6, atol=0)
    for c, bn in (((0.5, 0.3, 0.1), 0.3), ((0.9, 0.6, 0.05), 0.7)):
        c = np.float32(c)
        _close(thair.sigma_a_from_reflectance(c, bn),
               jhair.sigma_a_from_reflectance(jnp.asarray(c), bn),
               rtol=1e-6, atol=0)


def _lambertian(path, rho=0.5, n_mu=64):
    """tests/test_fourier.py's table: f = rho/π, only the k = 0 term, in
    the reflection quadrants (μi·μo < 0)."""
    mu = np.linspace(-1.0, 1.0, n_mu)
    coeffs = [[np.asarray([[rho / np.pi * abs(mu[i])
                            if mu[i] * mu[o] < 0 else 0.0]], np.float32)
               for o in range(n_mu)] for i in range(n_mu)]
    tfourier.write_bsdf(path, mu, coeffs, eta=1.0)


def _rgb_table(path, n_mu=24, seed=3):
    """A seeded three-channel table, five terms (some pairs fewer)."""
    rs = np.random.RandomState(seed)
    mu = np.sort(rs.uniform(-1, 1, n_mu))
    mu[0], mu[-1] = -1.0, 1.0
    coeffs = [[rs.uniform(0, 0.4, (3, rs.randint(1, 6))).astype(np.float32)
               for _ in range(n_mu)] for _ in range(n_mu)]
    tfourier.write_bsdf(path, mu, coeffs, eta=1.33)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("bsdf")
    paths = (str(d / "lam.bsdf"), str(d / "rgb.bsdf"))
    _lambertian(paths[0])
    _rgb_table(paths[1])
    return paths


def test_bsdf_files_round_trip_as_jax(tables):
    """The port's writer gives the bytes pbrt_tpu's writes, and both
    readers read the same tables."""
    for path in tables:
        t = tfourier.read_bsdf(path)
        j = bridge.fourier_from_jax((jfourier.read_bsdf(path),))[0]
        for k in ("mu", "a_dense", "m", "cdf", "eta"):
            assert torch.equal(getattr(t, k), getattr(j, k)), k
        assert (t.n_channels, t.m_max) == (j.n_channels, j.m_max)
    assert tfourier.read_bsdf(tables[0]).n_channels == 1
    assert tfourier.read_bsdf(tables[1]).m_max == 5
    mu = np.linspace(-1, 1, 5)
    coeffs = [[np.full((1, 2), i + o, np.float32) for o in range(5)]
              for i in range(5)]
    out = os.path.dirname(tables[0])
    tfourier.write_bsdf(os.path.join(out, "t.bsdf"), mu, coeffs, eta=1.2)
    jfourier.write_bsdf(os.path.join(out, "j.bsdf"), mu, coeffs, eta=1.2)
    with open(os.path.join(out, "t.bsdf"), "rb") as a, \
            open(os.path.join(out, "j.bsdf"), "rb") as b:
        assert a.read() == b.read()


def test_eval_fourier_set_matches_jax(tables):
    rs = np.random.RandomState(4)
    wo, wi = _unit(rs, N), _unit(rs, N)
    fid = rs.randint(-1, 2, N).astype(np.int32)
    jt = tuple(jfourier.read_bsdf(p) for p in tables)
    tt = tuple(tfourier.read_bsdf(p) for p in tables)
    for tj, tt_ in zip(jt, tt):
        _close(tfourier.eval_fourier(tt_, *_t(wo, wi)),
               jfourier.eval_fourier(tj, *_j(wo, wi)))
    for c in (3, 60):
        a = jfourier.eval_fourier_set(jt, jnp.asarray(fid), *_j(wo, wi), c)
        b = tfourier.eval_fourier_set(tt, torch.as_tensor(fid), *_t(wo, wi),
                                      c)
        assert float(np.asarray(a).max()) > 0.1
        _close(b, a, what=f"{c} channels")
    _close(tfourier.catmull_rom_weights(tt[1].mu, torch.as_tensor(wo[:, 2]))
           [1], jfourier.catmull_rom_weights(jt[1].mu,
                                             jnp.asarray(wo[:, 2]))[1])


def _material_rows(tables):
    """A hair, a Fourier (the RGB table), a matte and a glass row, built
    by pbrt_tpu and carried across; every lane gathers a random row."""
    b = JaxBuilder(RGB)
    fid = b.add_fourier_table(tables[1])
    b.add_material(type=jmat.HAIR, sss_sigma_a=(0.4, 0.8, 1.6), beta_m=0.3,
                   beta_n=0.4, hair_alpha=2.5, eta=1.55)
    b.add_material(type=jmat.FOURIER, fourier_id=fid)
    b.add_material(type=jmat.MATTE, kd=(0.2, 0.5, 0.7))
    b.add_material(type=jmat.GLASS, eta=1.5)
    b.add_sphere((0, 0, 0), 1.0)
    return b.build()


def test_bsdf_rows_match_jax(tables):
    """The HAIR and FOURIER rows beside matte and glass through the three
    BSDF functions, with the fiber offset and the tables passed and
    without them (h = 0, Fourier black: bdpt's, SPPM's and the hero
    loop's calls)."""
    js = _material_rows(tables)
    ts = bridge.scene_from_jax(js)
    assert ts.materials.has_hair and ts.materials.has_fourier
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 4, N).astype(np.int32)
    wo, wi = _unit(rs, N), _unit(rs, N)
    h = rs.uniform(-1, 1, N).astype(np.float32)
    u_l = rs.uniform(0, 1, N).astype(np.float32)
    u = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    jm = jmat.gather_materials(js.materials, jnp.asarray(ids))
    tm = tmat.gather_materials(ts.materials, torch.as_tensor(ids))
    for with_args in (True, False):
        jk = dict(h=jnp.asarray(h), fourier=js.fourier) if with_args else {}
        tk = dict(h=torch.as_tensor(h), fourier=ts.fourier) \
            if with_args else {}
        _close(tmat.bsdf_f(tm, *_t(wo, wi), **tk),
               jmat.bsdf_f(jm, *_j(wo, wi), **jk), what="f")
        _close(tmat.bsdf_pdf(tm, *_t(wo, wi), **tk),
               jmat.bsdf_pdf(jm, *_j(wo, wi), **jk), what="pdf")
        a = jmat.bsdf_sample(jm, *_j(wo, u_l, u), **jk)
        b = tmat.bsdf_sample(tm, *_t(wo, u_l, u), **tk)
        same = _same_lobe(a[0], b[0])
        for k, what in ((1, "sample f"), (2, "sample pdf")):
            _close(b[k].numpy()[same], np.asarray(a[k])[same], rtol=2e-3,
                   what=what)
        assert np.array_equal(b[3].numpy()[same], np.asarray(a[3])[same])
        if not with_args:
            four = ids == 1
            assert (b[1].numpy()[four] == 0).all()


def test_hair_fourier_pass_matches_jax(tables):
    """A `path` pass (24², 4 spp, independent sampler, max_depth 3) of a
    scene built by pbrt_tpu: a Lambertian Fourier sphere and three hair
    curves (eumelanin 1.3, and one with a reflectance color) over a matte
    floor under an area light, lane for lane."""
    b = JaxBuilder(RGB)
    fid = b.add_fourier_table(tables[0])
    floor = b.add_material(type=jmat.MATTE, kd=(0.6, 0.6, 0.55))
    four = b.add_material(type=jmat.FOURIER, fourier_id=fid)
    dark = b.add_material(type=jmat.HAIR, eta=1.55, sss_sigma_a=tuple(
        float(x) for x in np.asarray(jhair.sigma_a_from_concentration(1.3,
                                                                       0.0))))
    red = b.add_material(type=jmat.HAIR, beta_m=0.2, beta_n=0.5, eta=1.55,
                         sss_sigma_a=tuple(float(x) for x in np.asarray(
                             jhair.sigma_a_from_reflectance(
                                 jnp.asarray([0.8, 0.3, 0.1]), 0.5))))
    b.add_mesh(np.float32([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]]),
               np.int32([[0, 1, 2], [0, 2, 3]]), mat=floor)
    b.add_sphere((0.4, 0.35, 0.3), 0.35, mat=four)
    for k, m in enumerate((dark, red, dark)):
        x = -0.6 + 0.25 * k
        b.add_curve([(x, 0, -0.2), (x + 0.1, 0.3, -0.3), (x - 0.1, 0.6, -0.1),
                     (x + 0.05, 0.9, 0.0)], 0.06, 0.02, mat=m)
    light = b.add_light(type="area", L=(8.0, 8.0, 8.0))
    pid = b.add_aaplane((-0.5, 2.0, -0.5), (0.5, 2.0, 0.5), 1,
                        facing_fw=False, mat=floor, light=light)
    b.light_rows[light]["prim"] = ("pln", pid)
    js = b.build()
    ts = bridge.scene_from_jax(js)
    assert ts.n_crv == 3 and ts.materials.has_hair and len(ts.fourier) == 1
    from pbrt_tpu.core import transform as jtransform
    from pbrt_tpu.scene import camera as jcam
    jc = jcam.make_perspective(jtransform.look_at((0, 0.8, -2.4),
                                                  (0, 0.4, 0), (0, 1, 0)),
                               40.0, (24, 24))
    tc = bridge.camera_from_jax(jc)
    a = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", max_depth=3),
        24, 24, 4, jnp.asarray(0, jnp.uint32)))
    b_ = trender.render_pass(ts, tc, tfilm.make_filter("box"),
                             trender.RenderConfig(integrator="path",
                                                  max_depth=3),
                             24, 24, 4, 0, device="cpu")
    assert float(a.mean()) > 0.05
    np.testing.assert_allclose(b_.numpy(), a, rtol=1e-4, atol=1e-5)
