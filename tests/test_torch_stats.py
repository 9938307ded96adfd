"""The renderer's statistics and the port's remaining public surface
against pbrt_tpu: ``RenderConfig.collect_stats`` (the per-bounce counts of
live lanes of the wavefront loop, bench.py's dead-lane accounting), the
fused gate under it, the stats registry (``report_value``,
``clear_stats``, ``print_stats``'s distributions, ``device_trace``),
``render_image`` and ``entry()``.

Three jitted pbrt_tpu programs, each built once in a module fixture:
``path`` and ``direct`` passes with ``collect_stats`` (16² × 2 spp,
max_depth 4) and ``__graft_entry__.entry()``'s render step. Live counts
must be equal; images hold tests/test_torch_li_loop.py's tolerance (per
pixel rtol 1e-4 / atol 1e-5 with at most 6e-3 of the pixels outside,
mean rel 1e-3).

Run as a script (``PYTHONPATH=. python tests/test_torch_stats.py``) it
prints the constants chip_smoke.py's phase 23 holds the card to:
pbrt_tpu's live counts of bench.py's stats call (256² × 1 spp, max_depth
4, seed 0) and the mean of ``__graft_entry__.entry()``'s image.
"""

import dataclasses
import importlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.utils import stats as jstats
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import fused_path as tfused
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.utils import stats as tstats
from test_torch_intersect import jax_scene
from test_torch_li_loop import _assert_images_match

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RES = 16
SPP = 2
MAX_DEPTH = 4


def _pass_both(js, ts, cfg_kw, res=RES, spp=SPP):
    """pbrt_tpu's and the port's render_pass of one config with
    collect_stats: ((img, live) of pbrt_tpu, (img, live) of the port)."""
    jcfg = jrender.RenderConfig(collect_stats=True, **cfg_kw)
    j_img, j_live = jrender.render_pass(
        js, ge._camera((res, res)), jfilm.make_filter("box"), jcfg, res, res,
        spp, jnp.asarray(0, jnp.uint32))
    tcfg = trender.RenderConfig(collect_stats=True, **cfg_kw)
    t_img, t_live = trender.render_pass(
        ts, entry._camera((res, res), "cpu"), tfilm.make_filter("box"), tcfg,
        res, res, spp, 0, "cpu")
    return ((np.asarray(j_img), np.asarray(j_live)),
            (t_img.numpy(), t_live.numpy()))


@pytest.fixture(scope="module")
def portal():
    js = jax_scene(entry._fill_portal_scene, "projection")
    return js, bridge.scene_from_jax(js)


@pytest.fixture(scope="module")
def path_stats(portal):
    return _pass_both(*portal, dict(integrator="path", max_depth=MAX_DEPTH))


@pytest.fixture(scope="module")
def direct_stats():
    """`direct` on _sphere_cornell: matte rows and a point light, no
    delta lobe, so the port's loop stops after the first bounce."""
    js = jax_scene(entry._fill_sphere_cornell)
    ts = bridge.scene_from_jax(js)
    assert not trender.mat_mod.has_specular(ts.materials)
    return _pass_both(js, ts, dict(integrator="direct", max_depth=MAX_DEPTH))


def test_path_live_counts_equal_jax(path_stats):
    (j_img, j_live), (t_img, t_live) = path_stats
    assert t_live.dtype == np.float32 and t_live.shape == (MAX_DEPTH + 1,)
    assert t_live[0] == RES * RES * SPP
    np.testing.assert_array_equal(t_live, j_live)
    assert (np.diff(t_live) <= 0).all() and t_live[-1] > 0
    _assert_images_match(t_img, j_img)


def test_direct_live_counts_equal_jax_after_the_early_stop(direct_stats):
    """The entries after the port's static stop hold pbrt_tpu's masked
    counts: 0, every path has ended."""
    (j_img, j_live), (t_img, t_live) = direct_stats
    np.testing.assert_array_equal(t_live, j_live)
    assert t_live[0] == RES * RES * SPP and (t_live[1:] == 0).all()
    _assert_images_match(t_img, j_img)


def test_stats_leave_the_image_bit_equal(portal):
    """collect_stats changes nothing but the count: the loop's radiance
    on the projection scene (whose plain `path` pass takes the fused twin)
    and a whole pass of the portal-strategy scene (the loop either way),
    bit for bit."""
    _, ts = portal
    cfg = trender.RenderConfig(max_depth=MAX_DEPTH)
    cfg_s = dataclasses.replace(cfg, collect_stats=True)
    cam = entry._camera((RES, RES), "cpu")
    filt = tfilm.make_filter("box")
    rays, pid, sidx, _ = trender.camera_rays(cam, filt, cfg, RES, RES, SPP,
                                             0, "cpu")
    sfn = trender.make_sampler("independent")
    L = trender._li_loop(ts, rays.o, rays.d, pid, sidx, sfn, cfg, None)
    L_s, live = trender._li_loop(ts, rays.o, rays.d, pid, sidx, sfn, cfg_s,
                                 None)
    assert torch.equal(L, L_s) and live.shape == (MAX_DEPTH + 1,)
    scene_p = entry._portal_scene("cpu", "portal")
    img = trender.render_pass(scene_p, cam, filt, cfg, RES, RES, SPP, 0,
                              "cpu")
    img_s, live_p = trender.render_pass(scene_p, cam, filt, cfg_s, RES, RES,
                                        SPP, 0, "cpu")
    assert torch.equal(img, img_s) and float(img.mean()) > 0.05
    assert float(live_p[0]) == RES * RES * SPP


def test_fused_gate_refuses_stats(portal):
    """As pbrt_tpu's gate (ops/fused_path.py:93): a pass that counts live
    lanes runs the wavefront loop, which counts them."""
    _, ts = portal
    cfg = trender.RenderConfig(max_depth=MAX_DEPTH)
    assert tfused.eligible(ts, cfg)
    assert not tfused.eligible(ts, dataclasses.replace(cfg,
                                                       collect_stats=True))


@pytest.mark.parametrize("integrator", ["ao", "volpath", "hero_path_mis",
                                        "bdpt_t1"])
def test_stats_of_an_integrator_without_the_loop_raise(portal, integrator):
    _, ts = portal
    cfg = trender.RenderConfig(integrator=integrator, collect_stats=True)
    with pytest.raises(ValueError, match=integrator):
        trender.render_pass(ts, entry._camera((4, 4), "cpu"),
                            tfilm.make_filter("box"), cfg, 4, 4, 1, 0, "cpu")


def _registry_text(mod):
    mod.clear_stats()
    mod.counter_add("Intersections/Regular ray intersection tests", 1234567)
    mod.counter_add("Integrator/Camera rays traced", 65536)
    rng = np.random.default_rng(7)
    for v in rng.integers(0, 9, 40):
        mod.report_value("Integrator/Path length", int(v))
    for v in rng.random(25) * 3.0:
        mod.report_value("Lights/Light pdf", float(v))
    text = _printed(mod)
    mod.clear_stats()
    return text


def _printed(mod):
    f = io.StringIO()
    mod.print_stats(file=f)
    return f.getvalue()


def test_print_stats_matches_jax():
    """Counters and distributions print as pbrt_tpu's PrintStats does;
    ``clear_stats`` empties the registry (phases are wall times, left
    out)."""
    text = _registry_text(tstats)
    assert text == _registry_text(jstats)
    assert "avg" in text and "(min" in text
    assert _printed(tstats) == ""
    tstats.report_value("t", torch.tensor([2.5]))
    assert "avg 2.500 (min 2.500, max 2.500)" in _printed(tstats)
    tstats.clear_stats()


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    scene = entry._portal_scene("cpu", "portal")
    cfg = trender.RenderConfig(max_depth=2, collect_stats=True)
    with tstats.device_trace(str(tmp_path)) as prof:
        _, live = trender.render_pass(
            scene, entry._camera((8, 8), "cpu"), tfilm.make_filter("box"),
            cfg, 8, 8, 1, 0, "cpu")
    assert float(live[0]) == 64
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path) and os.path.getsize(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_render_image_is_render():
    from pbrt_tpu_torch.integrators import render_image
    assert render_image is trender.render is trender.render_image


@pytest.fixture(scope="module")
def entry_images():
    fn, args = ge.entry()
    want = np.asarray(fn(*args))
    tfn, targs = entry.entry(device="cpu")
    return tfn, targs, tfn(*targs).numpy(), want


def test_entry_matches_jax(entry_images):
    """The port's entry() against pbrt_tpu's on the CPU: the same 32² ×
    2-spp portal pass (the port's `path` through the fused twin, pbrt_tpu's
    through its loop, as on the CPU backend it does)."""
    tfn, targs, got, want = entry_images
    assert targs[0].geom.tri_v0.device.type == "cpu" and targs[3] == 0
    assert got.shape == want.shape == (32, 32, 3)
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 6e-3, f"{bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


def _reference_constants():
    """pbrt_tpu's live counts of bench.py's stats call and the mean of
    ``__graft_entry__.entry()``'s image, on the CPU."""
    js = ge._portal_scene()
    cfg = jrender.RenderConfig(integrator="path", max_depth=4,
                               collect_stats=True)
    _, live = jrender.render_pass(js, ge._camera((256, 256)),
                                  jfilm.make_filter("box"), cfg, 256, 256, 1,
                                  jnp.asarray(0, jnp.uint32))
    fn, args = ge.entry()
    return {"REF_LIVE_COUNTS": [int(v) for v in np.asarray(live)],
            "REF_ENTRY_MEAN": float(np.asarray(fn(*args),
                                               np.float64).mean())}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_reference_constants()))
