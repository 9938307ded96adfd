"""Gradients through the generic wavefront loop, the hero-wavelength loop
and `volpath`: torch autograd of the port's ``render_pass`` against
``jax.grad`` of pbrt_tpu's.

The same scene (built by pbrt_tpu, carried over with
``bridge.scene_from_jax``), the same camera, seed and spp go through both
packages' ``render_pass`` with ``integrator="path"``, ``max_depth`` 3, at
16² × 4 spp; the loss is the image mean. The port's fused gate is turned
off (``fused_profile=None``) so its ``path`` runs ``_li_loop``, as
pbrt_tpu's does on the CPU backend.

- **Brute-force scene**: the layout of tests/test_grad.py
  ``_portal_grad_scene`` (a floor, a vertical projection-strategy portal
  in front of a vertical area light), as ``entry._fill_portal_grad_scene``
  fills a builder; the port's own build of it gives the same gradients
  (chip_smoke.py takes them on the card). Gradients with
  respect to ``materials.kd``, ``lights.emit``, ``lights.portal_lo`` and
  ``lights.portal_hi``: the NEE direction toward a portal sample depends
  on the portal's corners, and one closest-hit trace along it serves both
  visibility and emission.
- **BVH scene**: the heightfield cornell scene at n = 8 with
  ``use_bvh="always"`` (286 triangles, one sphere, one aaplane light).
  Gradients with respect to kd and emit. Portal geometry is not taken
  here: pbrt_tpu's CPU traversal is a ``lax.while_loop``
  (pbrt_tpu/scene/bvh.py:483,544), and reverse mode cannot differentiate
  a while-loop carry with a tangent, which a ray direction that depends
  on the portal would give it. So pbrt_tpu gives no reference there.
- **Hero scene**: tests/oracle/cornell_dielectric_oracle.pbrt (60-bin
  spectra, two dispersive glass boxes) with ``hero_path_mis``, its
  halton sampler and depth, over a 16² window of its film × 4 spp.
  Gradients with respect to kd and emit, (M, 60) and (L, 60): the hero
  loop is a ``fori_loop`` of static trip count in pbrt_tpu, so reverse
  mode is defined.
- **Volpath scene**: tests/oracle/volpath_oracle.pbrt (a homogeneous
  medium inside a null sphere) with ``volpath``, its sampler and depth,
  over a 16² window × 4 spp. Gradients with respect to kd, emit and the
  medium's ``sigma_a`` and ``sigma_s``: pbrt_tpu's closed-form
  transmittance and distance sampling differentiate through them, and a
  medium event's point moves with them, so the next hit's distance
  carries their gradient (the port's ``scene/intersect.py::_attach_t``).
  pbrt_tpu's own gradients with respect to sigma are NaN: its clamped
  square roots (``jnp.sqrt(jnp.maximum(x, 0))``) give 0 · ∞ in reverse
  mode on lanes where x < 0, which that moving point reaches (ROADMAP
  queue 3). The reference is taken with √'s derivative set to 0 where
  its argument is ≤ 0 (``finite_sqrt_gradient``; values unchanged), as
  the port's ``core/vecmath.py::safe_sqrt`` takes it.
- **Subsurface scene**: tests/oracle/sss_oracle.pbrt (a kdsubsurface
  sphere on a matte floor) with its `path` integrator, sampler and depth,
  over the 16² window of the sphere's lit top (SSS_CROP) × 4 spp:
  gradients with respect to kd and emit through
  ``subsurface_transport``'s probe chain (the probe rays start on the hit
  and their hits carry ``t``'s gradient), with the same √ derivative as
  the volpath reference.
- **Hair scene**: tests/oracle/curves_oracle.pbrt with its two curves
  made of the hair material (eumelanin 1.3), over the 16² window
  (HAIR_CROP) where a curve covers 28% of the pixels × 4 spp: gradients
  with respect to kd and emit through HAIR rows of the BSDF, √ as
  above.

Each scene is one jitted pbrt_tpu program (``value_and_grad`` over all its
parameters), shared by the file's tests through module-scoped fixtures.
Tolerances: loss rtol 1e-5; every gradient atol 1e-6 + rtol 1e-4 of its
largest entry, elementwise; each gradient is non-trivial (max |g| > 1e-3).
"""

import contextlib
import dataclasses as dc
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.frontend import parse_pbrt_string as jparse
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RES = 16
SPP = 4
DEPTH = 3
BRUTE_PARAMS = ("kd", "emit", "portal_lo", "portal_hi")
BVH_PARAMS = ("kd", "emit")
HERO_PARAMS = ("kd", "emit")
VOLPATH_PARAMS = ("kd", "emit", "sigma_a", "sigma_s")
SSS_PARAMS = ("kd", "emit")
HAIR_PARAMS = ("kd", "emit")
HAIR_CROP = (52, 68, RES, RES)  # a curve's lit stretch on the ground
SSS_CROP = (40, 16, RES, RES)  # the sphere's lit top: max |∂/∂emit| > 1e-3
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oracle")
FILE_RES = 96
CROP = (40, 40, RES, RES)     # a 16² window of the files' 96² films


def _portal_grad_builder():
    """tests/test_grad.py ``_portal_grad_scene``'s layout."""
    b = JaxBuilder(RGB)
    entry._fill_portal_grad_scene(b)
    return b.build()


def _bvh_builder():
    b = JaxBuilder(RGB)
    entry._fill_heightfield_cornell(b, n=8, n_phi=8, n_z=4)
    return b.build(use_bvh="always")


def _camera(eye, target):
    return jcam.make_perspective(jtransform.look_at(eye, target, (0, 1, 0)),
                                 30.0, (RES, RES))


MEDIUM_FIELDS = ("sigma_a", "sigma_s")


def _with(scene, values):
    """``scene`` with the named parameters replaced (both packages' tables
    have the same field names); a medium's ``sigma_a`` / ``sigma_s`` are
    the scene's first medium's."""
    mats = {k: v for k, v in values.items() if k == "kd"}
    meds = {k: v for k, v in values.items() if k in MEDIUM_FIELDS}
    lts = {k: v for k, v in values.items()
           if k != "kd" and k not in MEDIUM_FIELDS}
    out = dc.replace(scene, materials=dc.replace(scene.materials, **mats),
                     lights=dc.replace(scene.lights, **lts))
    if meds:
        out = dc.replace(out, media=(dc.replace(scene.media[0], **meds),)
                         + tuple(scene.media[1:]))
    return out


def _table(scene, name):
    if name in MEDIUM_FIELDS:
        return getattr(scene.media[0], name)
    return getattr(scene.materials if name == "kd" else scene.lights, name)


def _both(js, cam, names, cfg=None, res=(RES, RES), crop=None):
    """(jax loss, jax grads, torch loss, torch grads) of the image mean;
    ``cfg`` is the RenderConfig's keywords (default: `path` at DEPTH)."""
    cfg = cfg or dict(integrator="path", max_depth=DEPTH)
    w, h = res

    def loss_jax(*vals):
        s = _with(js, dict(zip(names, vals)))
        return jnp.mean(jrender.render_pass(
            s, cam, jfilm.make_filter("box"), jrender.RenderConfig(**cfg),
            w, h, SPP, jnp.asarray(0, jnp.uint32), crop=crop) / SPP)

    argnums = tuple(range(len(names)))
    v, g = jax.value_and_grad(loss_jax, argnums=argnums)(
        *(_table(js, n) for n in names))

    ts = dc.replace(bridge.scene_from_jax(js), fused_profile=None)
    leaves = {n: _table(ts, n).clone().requires_grad_() for n in names}
    img = trender.render_pass(
        _with(ts, leaves), bridge.camera_from_jax(cam),
        tfilm.make_filter("box"), trender.RenderConfig(**cfg),
        w, h, SPP, 0, "cpu", crop=crop) / SPP
    loss = img.mean()
    loss.backward()
    return (float(v), {n: np.asarray(x) for n, x in zip(names, g)},
            float(loss.detach()), {n: leaves[n].grad.numpy()
                                   for n in names})


@pytest.fixture(scope="module")
def brute():
    js = _portal_grad_builder()
    assert js.bvh is None
    return _both(js, _camera((0, 2, -4), (0, 0.5, 0)), BRUTE_PARAMS)


@pytest.fixture(scope="module")
def bvh():
    js = _bvh_builder()
    assert js.bvh is not None
    return _both(js, _camera((0.5, 0.5, -1.4), (0.5, 0.5, 1.0)), BVH_PARAMS)


def _file_scene(name, spectrum_cfg=RGB):
    js, jc, jo = jload_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                            spectrum_cfg=spectrum_cfg)
    return js, jc, dict(integrator=jo["integrator"], sampler=jo["sampler"],
                        max_depth=jo["max_depth"])


@pytest.fixture(scope="module")
def hero():
    js, jc, cfg = _file_scene("cornell_dielectric", jspec.SAMPLED)
    assert js.n_channels == 60
    cfg["integrator"] = "hero_path_mis"
    return _both(js, jc, HERO_PARAMS, cfg, (FILE_RES, FILE_RES), CROP)


@contextlib.contextmanager
def finite_sqrt_gradient():
    """``jnp.sqrt`` with its derivative set to 0 where the argument is
    ≤ 0, its values unchanged, while pbrt_tpu's program is traced; jax's
    caches are cleared on both sides, so no program traced under it is
    reused without it, or the other way."""
    sqrt = jnp.sqrt

    @jax.custom_jvp
    def finite_sqrt(x):
        return sqrt(x)

    @finite_sqrt.defjvp
    def _(primals, tangents):
        (x,), (dx,) = primals, tangents
        y = sqrt(x)
        pos = x > 0
        return y, jnp.where(pos, dx * 0.5 / jnp.where(pos, y, 1.0), 0.0)

    jax.clear_caches()
    jnp.sqrt = finite_sqrt
    try:
        yield
    finally:
        jnp.sqrt = sqrt
        jax.clear_caches()


@pytest.fixture(scope="module")
def volpath():
    js, jc, cfg = _file_scene("volpath")
    assert cfg["integrator"] == "volpath" and len(js.media) == 1
    with finite_sqrt_gradient():
        return _both(js, jc, VOLPATH_PARAMS, cfg, (FILE_RES, FILE_RES),
                     CROP)


@pytest.fixture(scope="module")
def sss():
    js, jc, cfg = _file_scene("sss")
    assert js.has_sss
    with finite_sqrt_gradient():
        return _both(js, jc, SSS_PARAMS, cfg, (FILE_RES, FILE_RES),
                     SSS_CROP)


def _hair_text():
    """curves_oracle.pbrt with its curves made of hair."""
    with open(os.path.join(ORACLE, "curves_oracle.pbrt")) as f:
        text = f.read()
    old = 'Material "matte" "rgb Kd" [0.2 0.5 0.3]'
    assert old in text
    return text.replace(old, 'Material "hair" "float eumelanin" [1.3]')


@pytest.fixture(scope="module")
def hair():
    js, jc, jo = jparse(_hair_text(), base_dir=ORACLE)
    assert js.n_crv == 2
    cfg = dict(integrator=jo["integrator"], sampler=jo["sampler"],
               max_depth=jo["max_depth"])
    with finite_sqrt_gradient():
        return _both(js, jc, HAIR_PARAMS, cfg, (FILE_RES, FILE_RES),
                     HAIR_CROP)


def _check(result, name):
    v_jax, g_jax, v_t, g_t = result
    np.testing.assert_allclose(v_t, v_jax, rtol=1e-5)
    want, got = g_jax[name], g_t[name]
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3, (name, scale)
    np.testing.assert_allclose(got, want, atol=1e-6 + 1e-4 * scale,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("name", BRUTE_PARAMS)
def test_brute_scene_gradients_match_jax_grad(brute, name):
    _check(brute, name)


@pytest.mark.parametrize("name", BVH_PARAMS)
def test_bvh_scene_gradients_match_jax_grad(bvh, name):
    _check(bvh, name)


def test_port_built_grad_scene_gives_the_same_gradients(brute):
    """The scene built by the port's SceneBuilder with the port's camera
    (what chip_smoke.py renders on the card) gives the bridged scene's
    loss and gradients, to the same tolerance."""
    b = entry.SceneBuilder()
    entry._fill_portal_grad_scene(b)
    ts = dc.replace(b.build("cpu"), fused_profile=None)
    leaves = {n: _table(ts, n).clone().requires_grad_()
              for n in BRUTE_PARAMS}
    img = trender.render_pass(
        _with(ts, leaves), entry._grad_camera((RES, RES), "cpu"),
        tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", max_depth=DEPTH),
        RES, RES, SPP, 0, "cpu") / SPP
    img.mean().backward()
    _, _, v_t, g_t = brute
    np.testing.assert_allclose(float(img.mean().detach()), v_t, rtol=1e-5)
    for n in BRUTE_PARAMS:
        scale = float(np.abs(g_t[n]).max())
        np.testing.assert_allclose(leaves[n].grad.numpy(), g_t[n],
                                   atol=1e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("name", HERO_PARAMS)
def test_hero_scene_gradients_match_jax_grad(hero, name):
    _check(hero, name)


@pytest.mark.parametrize("name", VOLPATH_PARAMS)
def test_volpath_scene_gradients_match_jax_grad(volpath, name):
    _check(volpath, name)


@pytest.mark.parametrize("name", SSS_PARAMS)
def test_sss_probe_chain_gradients_match_jax_grad(sss, name):
    _check(sss, name)


@pytest.mark.parametrize("name", HAIR_PARAMS)
def test_hair_row_gradients_match_jax_grad(hair, name):
    _check(hair, name)
