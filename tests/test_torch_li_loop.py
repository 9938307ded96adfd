"""The generic wavefront loop as a whole: the port's render_pass against
pbrt_tpu's, for every ported integrator, on scenes outside the fused
profile and on the fused profile's own scene with each portal strategy.

Each scene is one list of builder calls (pbrt_tpu_torch/entry.py
``_fill_*``) run on pbrt_tpu's SceneBuilder; the port renders the bridged
scene, so both packages get the same tables, and on the CPU both go
through their generic loop (pbrt_tpu's fused gate is off on the CPU
backend; the port's ``path`` takes the fused twin only for the
projection strategy, which ties the two paths together here).

16² × 2 spp. Tolerances: per pixel rtol 1e-4 / atol 1e-5 with at most
6e-3 of the pixels outside (a float seam tie can send a lane to another
primitive, tests/test_fused_path.py:258-261), image mean rel 1e-3.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from test_torch_intersect import jax_scene

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RES = 16
SPP = 2
SCENES = {
    "portal_projection": (entry._fill_portal_scene, ("projection",)),
    "portal_portal": (entry._fill_portal_scene, ("portal",)),
    "portal_light": (entry._fill_portal_scene, ("light",)),
    "sphere_cornell": (entry._fill_sphere_cornell, ()),
}
# (scene, integrator, max_depth). max_depth 6 reaches the bounces (b > 3)
# where russian roulette runs. The portal and light strategies differ only
# in a table entry, so pbrt_tpu compiles one program for both per depth;
# `direct` and `whitted` lower to one program too. The projection strategy
# is inside the fused profile: the port's `path` then runs the fused twin,
# which tests/test_torch_render.py holds against pbrt_tpu's generic loop,
# and the test below holds the port's generic loop against that twin.
CASES = [(s, "path", md) for md in (4, 6)
         for s in ("portal_portal", "portal_light", "sphere_cornell")] + [
    ("sphere_cornell", i, 4) for i in ("mypath", "direct", "whitted", "ao")]


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, (fill, args) in SCENES.items():
        js = jax_scene(fill, *args)
        out[name] = (js, bridge.scene_from_jax(js))
    return out


def _render_both(scenes, name, integrator, max_depth):
    js, ts = scenes[name]
    want = np.asarray(jrender.render_pass(
        js, ge._camera((RES, RES)), jfilm.make_filter("box"),
        jrender.RenderConfig(integrator=integrator, max_depth=max_depth),
        RES, RES, SPP, jnp.asarray(0, jnp.uint32)))
    got = trender.render_pass(
        ts, entry._camera((RES, RES), "cpu"), tfilm.make_filter("box"),
        trender.RenderConfig(integrator=integrator, max_depth=max_depth),
        RES, RES, SPP, 0, "cpu").numpy()
    return got, want


def _assert_images_match(got, want):
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and want.mean() > 0.05
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 6e-3, f"{bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


@pytest.mark.parametrize("name,integrator,max_depth", CASES,
                         ids=[f"{s}-{i}-depth{d}" for s, i, d in CASES])
def test_render_pass_matches_jax(scenes, name, integrator, max_depth):
    got, want = _render_both(scenes, name, integrator, max_depth)
    _assert_images_match(got, want)


def test_li_loop_equals_fused_twin_on_the_projection_scene(scenes):
    """`path` on the projection-strategy scene takes the fused twin; the
    generic loop on the same lanes gives its radiance (pbrt_tpu states
    this equality at integrators/render.py:90-94). Per-lane atol 1e-5."""
    _, ts = scenes["portal_projection"]
    cfg = trender.RenderConfig(max_depth=6)
    rays, pid, sidx, _ = trender.camera_rays(
        entry._camera((RES, RES), "cpu"), tfilm.make_filter("box"), cfg, RES,
        RES, SPP, 0, "cpu")
    sfn = trender.make_sampler("independent")
    assert trender.fused_path.eligible(ts, cfg)
    fused = trender.li_path(ts, rays.o, rays.d, pid, sidx, sfn, cfg, None)
    loop = trender._li_loop(ts, rays.o, rays.d, pid, sidx, sfn, cfg, None)
    torch.testing.assert_close(loop, fused, atol=1e-5, rtol=0)
    assert float(fused.mean()) > 0.05


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bridge_equals_port_builder(scenes, name):
    """``bridge.scene_from_jax`` against the port's own SceneBuilder on
    the same builder calls, field by field: spheres, shading normals,
    uvs, every light row, the portals, the static flags."""
    fill, args = SCENES[name]
    b = entry.SceneBuilder()
    fill(b, *args)
    built = dict(_fields(b.build("cpu")))
    bridged = dict(_fields(scenes[name][1]))
    assert set(built) == set(bridged)
    for key in ("geom.sph_center", "geom.tri_n0", "geom.tri_uv2",
                "lights.ltype", "lights.pos", "lights.power",
                "lights.present", "lights.has_plain_area", "n_sph"):
        assert key in built
    for key, want in bridged.items():
        have = built[key]
        if isinstance(want, torch.Tensor):
            assert have.dtype == want.dtype and have.shape == want.shape, key
            assert torch.equal(have, want), key
        else:
            assert have == want, key


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend for the renders
    that chip_smoke.py checks on the card (same scenes, same sample
    streams; samples are keyed by their absolute index, so pbrt_tpu's
    smaller CPU chunks only reorder the sum). Run this file as a script
    from the root of the checkout, ``PYTHONPATH=. python
    tests/test_torch_li_loop.py``, to print them."""
    out = {}
    for name, integrator, res, spp in [
            ("portal_portal", "path", 256, 64),
            ("sphere_cornell", "path", 256, 64),
            ("sphere_cornell", "direct", 64, 4),
            ("sphere_cornell", "whitted", 64, 4),
            ("sphere_cornell", "ao", 64, 4),
            ("sphere_cornell", "mypath", 64, 4)]:
        fill, args = SCENES[name]
        img = jrender.render(jax_scene(fill, *args), ge._camera((res, res)),
                             spp=spp, integrator=integrator, max_depth=4)
        out[f"{name}/{integrator}/{res}x{res}/{spp}spp"] = float(
            np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
