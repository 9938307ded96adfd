"""The hero-wavelength slice against pbrt_tpu: 60-bin spectra, the
wavelength packets, the BSDFs at 60 channels, whole `hero_path` and
`hero_path_mis` passes, and cornell_dielectric_oracle.pbrt against the
reference binary.

(a) Spectral tables. ``_tables()`` (bin centres, the (3,60) spectrum →
    RGB matrix, the RGB → spectrum basis) and the sampled
    ``spd_from_pairs`` equal pbrt_tpu's exactly; ``rgb_to_spectrum`` and
    ``spectrum_to_rgb`` on 4,096 seeded colors and spectra equal them to
    1e-7 relative (measured: bit for bit, the port sums in XLA's order);
    ``spectrum_to_xyz`` to 1e-6 (its CIE table is float32 arithmetic,
    torch's exp against XLA's: 1 ulp on 6% of the entries).
    ``index_from_wavelength`` at the edges of the range and of a bin,
    ``rotate_sample`` at u = 1 − 2⁻²⁴ and at sums that round to 1: exact.
(b) Wavelength packets: ``sample_hero_wavelengths`` on 4,096 lanes of
    the pass scene, with the independent and the halton sampler: bins
    exact, λ and pmf to 1e-6 relative (the CDF is a float32 cumsum that
    XLA adds in another order).
(c) BSDFs at C = 60. Every ported family of tests/test_torch_materials.py
    lifted to 60 bins, through ``bsdf_f``, ``bsdf_pdf``, ``bsdf_sample``
    and ``bsdf_sample(eta_override=cauchy_eta(…))`` of pbrt_tpu (one
    jitted program) and of the port, with that test's bounds: flags
    equal, rtol 2e-4 / atol 2e-5 on every lane, at most 8 lanes beyond
    rtol 1e-5 / atol 1e-6 but for Beckmann's (measured: 6 of 4,096, each
    with one of its 60 channels or a direction's small component out; at
    C = 3 that test allows 4), away
    from the port's one deviation (a microfacet reflection under the
    surface, ROADMAP queue 3; that test holds it).
(d) Whole passes: one `hero_path_mis` pass (halton) and one `hero_path`
    pass (independent) at 16², 4 spp, max_depth 5 of one scene built by
    pbrt_tpu's SceneBuilder(SAMPLED) and carried over by ``bridge``: a
    dispersive glass prism in a matte box, an aaplane area light and a
    constant infinite light. Per pixel, all 60 bins: rtol 1e-4 /
    atol 1e-5 with at most 2% of the pixels outside (measured: 0 of 256
    in both), means to 1e-5. These are the file's other two jitted
    pbrt_tpu programs. The port's own SceneBuilder builds the bridged
    tables field for field (the constant map's CDFs to rtol 1e-6), and
    the prism's dispersion changes the image (a prism of one index
    renders another).
(e) The file: the port's CPU render of cornell_dielectric_oracle.pbrt
    with tests/test_oracle.py's call (SAMPLED, 32 spp, halton, box filter)
    holds that test's limits against the reference binary's image: mean
    delta < 0.05, block relative L1 (k = 16) < 0.20 (measured: 0.0164 /
    0.1065; pbrt_tpu's, by that test's docstring, 0.025 / 0.106).
(f) A sampled scene never reaches the fused kernel: a fused-profile scene
    built with 60 bins has no profile and ``eligible`` refuses it.

``PYTHONPATH=. python tests/test_torch_hero.py`` prints pbrt_tpu's 8-spp
image means of the file for chip_smoke.py's REF_HERO_MEANS.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.integrators import hero as jhero
from pbrt_tpu.samplers import make_sampler as jmake_sampler
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import materials as jm
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.core import spectrum as tspec
from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import hero as thero
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.samplers import make_sampler as tmake_sampler
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import materials as tm
from pbrt_tpu_torch.scene.types import SceneBuilder

jrender = importlib.import_module("pbrt_tpu.integrators.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
DIELECTRIC = os.path.join(ORACLE, "cornell_dielectric_oracle.pbrt")
N = 4096
RES = 16
SPP = 4
QUAD = [(0, 1, 2), (0, 2, 3)]


def fill_prism(b, cauchy_c=0.012):
    """A matte box around a dispersive glass prism, lit by an aaplane area
    light under the ceiling and a constant infinite light (RGB parameters,
    lifted to 60 bins by the builder)."""
    white = b.add_material(type=tm.MATTE, kd=(0.7, 0.7, 0.7))
    red = b.add_material(type=tm.MATTE, kd=(0.6, 0.1, 0.1))
    green = b.add_material(type=tm.MATTE, kd=(0.1, 0.6, 0.1))
    black = b.add_material(type=tm.MATTE, kd=0.0)
    glass = b.add_material(type=tm.DISPERSIVE_GLASS, eta=1.3, cauchy_b=1.28,
                           cauchy_c=cauchy_c)
    b.add_mesh([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], QUAD, mat=white)
    b.add_mesh([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], QUAD, mat=white)
    b.add_mesh([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], QUAD, mat=red)
    b.add_mesh([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], QUAD,
               mat=green)
    b.add_mesh([(0.3, 0.05, 0.4), (0.7, 0.05, 0.4), (0.5, 0.45, 0.45),
                (0.3, 0.05, 0.7), (0.7, 0.05, 0.7), (0.5, 0.45, 0.75)],
               [(0, 1, 2), (3, 5, 4), (0, 3, 4), (0, 4, 1), (1, 4, 5),
                (1, 5, 2), (2, 5, 3), (2, 3, 0)], mat=glass)
    li = b.add_light(type="area", L=(12.0, 10.0, 8.0), prim=-1)
    pid = b.add_aaplane((0.35, 0.99, 0.35), (0.65, 0.99, 0.65), axis=1,
                        facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = ("pln", pid)
    b.add_light(type="infinite", L=(0.3, 0.35, 0.4),
                env_map=np.ones((1, 1, 3), np.float32))


def prism_camera(res):
    return jcam.make_perspective(
        jtransform.look_at((0.5, 0.5, -1.2), (0.5, 0.4, 1.0), (0, 1, 0)),
        40.0, res)


@pytest.fixture(scope="module")
def prism():
    b = JaxBuilder(jspec.SAMPLED)
    fill_prism(b)
    js = b.build()
    return js, bridge.scene_from_jax(js)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# (a) spectral tables
# ---------------------------------------------------------------------------

def test_spectral_tables_match_jax():
    for want, have in zip(jspec._tables(), tspec._tables()):
        assert have.dtype == want.dtype and np.array_equal(have, want)
    rng = np.random.default_rng(3)
    rgb = (rng.random((N, 3)) * 3.0).astype(np.float32)
    spec = rng.random((N, 60)).astype(np.float32)
    for fn, x, rtol in (("rgb_to_spectrum", rgb, 1e-7),
                        ("spectrum_to_rgb", spec, 1e-7),
                        ("spectrum_to_xyz", spec, 1e-6)):
        want = _np(getattr(jspec, fn)(jnp.asarray(x)))
        for have in (getattr(tspec, fn)(x),
                     getattr(tspec, fn)(torch.as_tensor(x)).numpy()):
            assert have.dtype == np.float32, fn
            np.testing.assert_allclose(have, want, rtol=rtol, atol=0,
                                       err_msg=fn)
    # one color (the builder's call) as a batch of them
    np.testing.assert_allclose(
        tspec.from_rgb(rgb[5], tspec.SAMPLED),
        _np(jspec.from_rgb(jnp.asarray(rgb[5]), jspec.SAMPLED)), rtol=1e-7,
        atol=0)
    np.testing.assert_allclose(
        tspec.luminance(torch.as_tensor(spec), tspec.SAMPLED).numpy(),
        _np(jspec.luminance(jnp.asarray(spec), jspec.SAMPLED)), rtol=1e-6,
        atol=1e-7)
    lam = [400, 430.5, 452.0, 700]
    vals = [0.0, 8.0, 15.6, 18.4]
    for cfg in ("SAMPLED", "RGB"):
        assert np.array_equal(
            tspec.spd_from_pairs(lam, vals, getattr(tspec, cfg)),
            jspec.spd_from_pairs(lam, vals, getattr(jspec, cfg)))
    # the bin index truncates toward zero in float32 and clips
    w = np.array([350.0, 399.9, 400.0, 404.99997, 405.0, 405.00003, 549.99997,
                  550.0, 699.99994, 700.0, 720.0], np.float32)
    np.testing.assert_array_equal(
        tspec.index_from_wavelength(torch.as_tensor(w)).numpy(),
        _np(jspec.index_from_wavelength(jnp.asarray(w))))
    # a rotated sample that rounds to 1 wraps to 0
    u = np.array([0.0, 1 - 2**-24, 0.25, 0.5 - 2**-25, 0.75 - 2**-25,
                  1 - 2**-23, 0.123456], np.float32)
    for i in range(4):
        have = tspec.rotate_sample(torch.as_tensor(u), i, 4).numpy()
        np.testing.assert_array_equal(have, _np(
            jspec.rotate_sample(jnp.asarray(u), i, 4)))
        assert ((have >= 0) & (have < 1)).all()
    assert tspec.rotate_sample(torch.tensor([0.5 - 2**-25]), 2).item() == 0


# ---------------------------------------------------------------------------
# (b) wavelength packets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["independent", "halton"])
def test_hero_wavelengths_match_jax(prism, sampler):
    js, ts = prism
    res = (64, 64)
    lane = np.arange(N)
    pid = lane % (res[0] * res[1])
    sidx = lane // (res[0] * res[1]) + 3
    want = jhero.sample_hero_wavelengths(
        js, jnp.asarray(pid, jnp.uint32), jnp.asarray(sidx, jnp.uint32),
        jmake_sampler(sampler, resolution=res), 0)
    have = thero.sample_hero_wavelengths(
        ts, torch.as_tensor(pid), torch.as_tensor(sidx),
        tmake_sampler(sampler, resolution=res), 0)
    wvl, idx, pmf = (x.numpy() for x in have)
    np.testing.assert_array_equal(idx, _np(want[1]))
    np.testing.assert_allclose(wvl, _np(want[0]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pmf, _np(want[2]), rtol=1e-6, atol=0)
    assert idx.dtype == np.int32 and ((wvl >= 400) & (wvl < 700)).all()
    # four distinct uniforms a quarter apart: the packet spreads
    assert (np.ptp(wvl, axis=-1) > 30).mean() > 0.9


# ---------------------------------------------------------------------------
# (c) BSDFs at 60 channels
# ---------------------------------------------------------------------------

def _rows60(rows):
    keys = [k for k, (_, per_channel) in tm._DEFAULTS.items() if per_channel]
    out = []
    for r in rows:
        r = dict(r)
        for k in keys:
            if k in r and np.ndim(r[k]) == 1:
                r[k] = tspec.rgb_to_spectrum(np.asarray(r[k], np.float32))
        out.append(r)
    return out


def test_bsdfs_at_60_channels_match_jax():
    from test_torch_materials import BECKMANN_ROWS, TABLE_ROWS, _unit
    rows = _rows60(TABLE_ROWS)
    rng = np.random.default_rng(17)
    wo, wi = _unit(rng, N), _unit(rng, N)
    ul = rng.random(N).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    lam = (400.0 + 300.0 * rng.random(N)).astype(np.float32)
    mid = (np.arange(N) % len(rows)).astype(np.int32)
    jt = jm.make_material_table(rows, 60)
    tt = tm.make_material_table(rows, 60)
    assert tt.kd.shape == (len(rows), 60) and tt.present == tuple(jt.present)

    @jax.jit
    def run(table, wo, wi, ul, u, lam, mid):
        mp = jm.gather_materials(table, mid)
        eta = jm.cauchy_eta(mp.cauchy_b, mp.cauchy_c, lam)
        return (jm.bsdf_f(mp, wo, wi), jm.bsdf_pdf(mp, wo, wi)) \
            + tuple(jm.bsdf_sample(mp, wo, ul, u)) \
            + tuple(jm.bsdf_sample(mp, wo, ul, u, eta_override=eta)) \
            + (eta,)

    want = [_np(x) for x in run(jt, wo, wi, ul, u, lam, mid)]
    T = torch.as_tensor
    mp = tm.gather_materials(tt, T(mid))
    eta = tm.cauchy_eta(mp.cauchy_b, mp.cauchy_c, T(lam))
    got = [x.numpy() for x in (
        [tm.bsdf_f(mp, T(wo), T(wi)), tm.bsdf_pdf(mp, T(wo), T(wi))]
        + list(tm.bsdf_sample(mp, T(wo), T(ul), T(u)))
        + list(tm.bsdf_sample(mp, T(wo), T(ul), T(u), eta_override=eta))
        + [eta])]
    np.testing.assert_allclose(got[10], want[10], rtol=1e-6, atol=0)
    beck = mid >= len(rows) - len(BECKMANN_ROWS)
    # a reflection under the surface is the port's one deviation
    # (tests/test_torch_materials.py holds it)
    inside = (wo[:, 2] < 0) & (wi[:, 2] < 0)
    outside = np.zeros(N, bool)
    for base in (2, 6):
        np.testing.assert_array_equal(got[base + 3], want[base + 3])
        np.testing.assert_allclose(got[base], want[base], rtol=2e-4,
                                   atol=2e-5)
        inside_s = (wo[:, 2] < 0) & (got[base][:, 2] < 0)
        outside |= ~np.isclose(got[base], want[base], rtol=1e-5,
                               atol=1e-6).all(-1)
        for k, keep in ((0, ~inside), (1, ~inside), (base + 1, ~inside_s),
                        (base + 2, ~inside_s)):
            if base == 6 and k < 2:
                continue
            g, w = got[k], want[k]
            assert g.shape == w.shape and np.isfinite(g).all(), k
            np.testing.assert_allclose(g[keep], w[keep], rtol=2e-4,
                                       atol=2e-5, err_msg=str(k))
            close = np.isclose(g, w, rtol=1e-5, atol=1e-6)
            outside |= keep & ~close.reshape(N, -1).all(-1)
    assert outside[~beck].sum() <= 8, np.nonzero(outside)[0]
    assert got[0].shape == (N, 60) and (got[0][~inside] > 0).any()
    # eta(λ) bends a dispersive row's refraction: the override moves it
    disp = (tt.mtype.numpy()[mid] == tm.DISPERSIVE_GLASS) \
        & ((got[5] & tm.FLAG_TRANSMISSION) > 0) \
        & ((got[9] & tm.FLAG_TRANSMISSION) > 0)
    assert disp.sum() > 20
    assert (np.abs(got[2][disp] - got[6][disp]).max(-1) > 1e-4).mean() > 0.9


# ---------------------------------------------------------------------------
# (d) whole passes
# ---------------------------------------------------------------------------

def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def test_bridge_equals_port_builder_sampled(prism):
    b = SceneBuilder(tspec.SAMPLED)
    fill_prism(b)
    built = dict(_fields(b.build("cpu")))
    bridged = dict(_fields(prism[1]))
    assert set(built) == set(bridged) and built["n_channels"] == 60
    for key, want in bridged.items():
        have = built[key]
        if isinstance(want, torch.Tensor):
            assert have.dtype == want.dtype and have.shape == want.shape, key
            if key.startswith("lights.env_distr."):
                torch.testing.assert_close(have, want, rtol=1e-6, atol=0)
            else:
                assert torch.equal(have, want), key
        else:
            assert have == want, key


def _port_pass(ts, integrator, sampler):
    return trender.render_pass(
        ts, bridge.camera_from_jax(prism_camera((RES, RES))),
        tfilm.make_filter("box"),
        trender.RenderConfig(integrator=integrator, sampler=sampler,
                             max_depth=5), RES, RES, SPP, 0, "cpu").numpy()


@pytest.mark.parametrize("integrator,sampler", [
    ("hero_path_mis", "halton"), ("hero_path", "independent")])
def test_hero_pass_matches_jax(prism, integrator, sampler):
    js, ts = prism
    want = _np(jrender.render_pass(
        js, prism_camera((RES, RES)), jfilm.make_filter("box"),
        jrender.RenderConfig(integrator=integrator, sampler=sampler,
                             max_depth=5),
        RES, RES, SPP, jnp.asarray(0, jnp.uint32)))
    got = _port_pass(ts, integrator, sampler)
    assert got.shape == want.shape == (RES, RES, 60)
    assert np.isfinite(got).all() and want.mean() > 0.1
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 2e-2, f"{bad.sum()} pixels differ"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5)
    # the prism disperses: one index everywhere renders another image
    b = SceneBuilder(tspec.SAMPLED)
    fill_prism(b, cauchy_c=0.0)
    flat = _port_pass(b.build("cpu"), integrator, sampler)
    assert np.abs(flat - got).max() > 1e-2


# ---------------------------------------------------------------------------
# (e) the file against the reference binary, (f) the fused gate
# ---------------------------------------------------------------------------

def test_cornell_dielectric_matches_reference_binary():
    from test_oracle import _block_rel_l1, _load_ref, _mean_delta
    ref = _load_ref("cornell_dielectric_ref.pfm")
    scene, cam, opts = load_pbrt(DIELECTRIC, spectrum_cfg=tspec.SAMPLED,
                                 device="cpu")
    assert scene.n_channels == 60 and scene.n_tri == 32 and scene.bvh is None
    img = trender.render(scene, cam, spp=32, integrator=opts["integrator"],
                         sampler="halton",
                         max_depth=min(opts["max_depth"], 8), device="cpu")
    assert opts["integrator"] == "hero_path_mis" and img.shape[-1] == 60
    img = tspec.spectrum_to_rgb(img).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < 0.05, f"mean delta {md:.4f} vs reference binary"
    assert bl < 0.20, f"block rel-L1 {bl:.4f} vs reference binary"


def test_sampled_scene_never_reaches_the_fused_kernel():
    rgb = entry._portal_scene("cpu")
    assert rgb.fused_profile is not None
    b = SceneBuilder(tspec.SAMPLED)
    entry._fill_portal_scene(b, "projection")
    scene = b.build("cpu")
    assert scene.n_channels == 60 and scene.fused_profile is None
    assert not fused_path.eligible(scene, trender.RenderConfig())


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend of
    cornell_dielectric_oracle.pbrt with the hero integrators, at its own
    resolution and max depth, SAMPLED, 8 spp, the halton sampler, the
    file's gaussian filter, seed 0 (chip_smoke.py's REF_HERO_MEANS).
    ``PYTHONPATH=. python tests/test_torch_hero.py`` prints them."""
    from pbrt_tpu.frontend import load_pbrt as jload
    js, jc, jo = jload(DIELECTRIC, spectrum_cfg=jspec.SAMPLED)
    fname, fkw = jo["filter"]
    out = {}
    for integrator in ("hero_path_mis", "hero_path"):
        img = jrender.render(js, jc, spp=8, integrator=integrator,
                             sampler="halton", max_depth=jo["max_depth"],
                             filter_name=fname, filter_kwargs=fkw, seed=0)
        out[integrator] = float(np.asarray(
            jspec.spectrum_to_rgb(img), np.float64).mean())
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(reference_means())
