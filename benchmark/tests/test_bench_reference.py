"""The plain reference at a tiny size: it runs, and it follows the
program lane for lane on the CPU, where the program runs its twins."""

import dataclasses

import pytest
import torch

from benchmark import compare, spec
from benchmark.reference import cornell_portal as ref

SCENE = str(spec.ROOT / "benchmark/scenes/cornell_portal.pbrt")
CONFIG = spec.load_json(spec.HERE / "configs" / "cornell_portal.json")


@pytest.fixture(scope="module")
def program():
    from pbrt_tpu_torch.frontend import load_pbrt

    scene, cam, opts = load_pbrt(SCENE, device="cpu")
    return scene, dataclasses.replace(cam, resolution=(24, 24)), opts


def test_scene_tables_equal_the_programs(program):
    scene, _, opts = program
    sc = ref.load(SCENE, CONFIG, "cpu")
    assert torch.equal(sc.kd.float(), scene.materials.kd)
    assert torch.equal(sc.emit.float(), scene.lights.emit[0])
    # the scene file's own maxdepth agrees with the configuration's,
    # which both sides are given
    assert sc.max_depth == CONFIG["max_depth"] == opts["max_depth"] == 4
    assert sc.v0.shape[0] == scene.n_tri == 26
    assert sc.resolution == (256, 256)


@pytest.mark.parametrize("seed", [0, 3_000_000_007])
def test_image_follows_the_program(program, seed):
    from pbrt_tpu_torch.integrators.render import render

    scene, cam, _ = program
    img = render(scene, cam, spp=4, integrator="path", max_depth=4,
                 seed=seed, device="cpu")
    sc = ref.load(SCENE, CONFIG, "cpu")
    r = ref.render(sc, sc.kd, sc.emit, 24, 24, 4, seed)
    assert compare.rel_l1(img, r) < 1e-5


def test_live_counts_follow_the_programs_kernel(program):
    from pbrt_tpu_torch.integrators.render import RenderConfig, camera_rays
    from pbrt_tpu_torch.ops import fused_path as fp
    from pbrt_tpu_torch.scene import film

    scene, cam, _ = program
    cfg = RenderConfig(integrator="path", max_depth=4, seed=11)
    rays, pid, sidx, _ = camera_rays(cam, film.make_filter("box"), cfg, 24,
                                     24, 2, 0, "cpu")
    ax, plf, pof, n_mat, mode = scene.fused_profile
    tri, msc, clu, n_clu = fp.pack_fused(scene, mode)
    code, _, _ = fp.fused_bounce(
        tri, msc, scene.materials.kd, clu, rays.o, rays.d,
        pid.to(torch.int32), sidx.to(torch.int32), n_tri=scene.n_tri, n_b=5,
        ax=ax, pl_facing=plf, portal_facing=pof, n_mat=n_mat, seed=11,
        rr_threshold=1.0, mode=mode, n_clu=n_clu)
    want = fp.live_mask(code).sum(1).tolist()
    sc = ref.load(SCENE, CONFIG, "cpu")
    got = ref.pass_counts(sc, 24, 24, range(2), 11)
    assert got == {"lanes": 24 * 24 * 2, "n_tri": 26, "live": want}


@pytest.mark.parametrize("key,value", [("integrator", "bdpt"),
                                       ("sampler", "halton"),
                                       ("filter", "gaussian")])
def test_settings_it_does_not_implement_are_refused(key, value):
    with pytest.raises(ValueError, match=key):
        ref.load(SCENE, dict(CONFIG, **{key: value}), "cpu")


def test_max_depth_is_the_configurations():
    sc = ref.load(SCENE, dict(CONFIG, max_depth=2), "cpu")
    live = ref.pass_counts(sc, 8, 8, range(1), 3)["live"]
    assert sc.max_depth == 2 and len(live) == 3


def test_training_steps_run_and_are_differentiable():
    sc = ref.load(SCENE, CONFIG, "cpu")
    tgt = ref.render(sc, sc.kd, sc.emit, 8, 8, 2, 5)
    losses, g, p = ref.train(sc, sc.kd * 1.1, sc.emit * 0.9, tgt, [1, 2], 8,
                             8, 2, 1.0)
    assert len(losses) == 2 and all(x > 0 for x in losses)
    assert float(g["kd"][1:7].abs().sum()) > 0
    assert float(g["emit"].abs().sum()) > 0
    assert not torch.equal(p["kd"], sc.kd * 1.1)
